"""Sigma-point (unscented) quadrature inference.

Counterpart of ``benchmarking_mpc_solvers_tpu/estimation/quadrature.py``:
the (α, β, κ) sigma-point construction, Cholesky propagation and moment
matching as plain functions. The centre-point weights are zeroed after
construction, as in the reference (its ``quadrature.py:34-36``), since
downstream moments depend on it. Means and covariances take any leading
batch dimensions.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from ..ops.linearize import mT


class SigmaPoints(NamedTuple):
    base_pts: torch.Tensor  # (2d+1, d) unit directions
    wghts_m: torch.Tensor  # (2d+1,) mean weights
    wghts_sig: torch.Tensor  # (2d+1,) covariance weights
    sf: float  # sqrt(d + λ) scale


def make_sigma_points(alpha: float, beta: float, kappa: float, dim: int,
                      device="cuda") -> SigmaPoints:
    device = resolve_device(device)
    lam = alpha**2 * (dim + kappa) - dim
    sf = float(np.sqrt(dim + lam))
    n = 2 * dim + 1
    w_m = np.full((n,), 1.0 / (2.0 * (dim + lam)), np.float32)
    w_m[0] *= 2.0 * lam
    w_sig = w_m.copy()
    w_sig[0] += 1.0 - alpha**2 + beta
    # the reference's quirk: centre weights zeroed after construction
    w_m[0] = 0.0
    w_sig[0] = 0.0
    base = np.vstack([np.zeros((1, dim)), np.eye(dim), -np.eye(dim)]).astype(np.float32)
    return SigmaPoints(torch.tensor(base, device=device), torch.tensor(w_m, device=device),
                       torch.tensor(w_sig, device=device), sf)


def propagate(sp: SigmaPoints, m_x, sig_x):
    """Sigma points m + base·(sf·chol(Σ))ᵀ: (..., 2d+1, d)."""
    scale = sp.sf * torch.linalg.cholesky(sig_x)
    return m_x[..., None, :] + sp.base_pts @ mT(scale)


def moments(sp: SigmaPoints, f: Callable, m_x, sig_x):
    """Propagate through f and moment-match: returns (m_y, sig_y, sig_xy).
    f maps (..., n, d) points -> (..., n, dy)."""
    x_pts = propagate(sp, m_x, sig_x)
    y_pts = f(x_pts)
    m_y = (sp.wghts_m[:, None] * y_pts).sum(dim=-2)
    wy = sp.wghts_sig[:, None] * y_pts
    sig_y = mT(wy) @ y_pts - m_y[..., :, None] * m_y[..., None, :]
    sig_xy = mT(sp.wghts_sig[:, None] * x_pts) @ y_pts - m_x[..., :, None] * m_y[..., None, :]
    return m_y, sig_y, sig_xy
