"""Unscented/cubature Kalman filter and smoother for nonlinear systems.

Counterpart of ``benchmarking_mpc_solvers_tpu/estimation/cubature.py``:
filter and smoother for arbitrary (dynamics, observe) functions, built on
the sigma-point moment matching of ``quadrature.py``. Plain PyTorch, a
Python loop over the sequence; priors, controls and measurements take any
leading batch dimensions.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from ..device import resolve_device
from ..ops.linearize import mT, mv
from .kalman import FilterResult, SmootherResult, batch_prior, gain, rts_pass, stack_filter
from .quadrature import SigmaPoints, make_sigma_points, moments


class UKFModel(NamedTuple):
    dynamics: Callable  # (pts (..., n, S), u (..., U)) -> (..., n, S)
    observe: Callable  # (pts (..., n, S)) -> (..., n, Y)
    sig_eta: torch.Tensor  # (S, S) process noise cov
    sig_zeta: torch.Tensor  # (Y, Y) observation noise cov


def ukf_filter(model: UKFModel, sp: SigmaPoints, mu0, sig0, us, ys) -> FilterResult:
    mu0, sig0 = batch_prior(mu0, sig0, us, ys)
    mu, sig = mu0, sig0
    mu_f, sig_f, mu_p, sig_p = [], [], [], []
    for t in range(us.shape[-2]):
        u = us[..., t, :]
        # predict through the nonlinear dynamics
        mu_t, sig_t, _ = moments(sp, lambda pts: model.dynamics(pts, u), mu, sig)
        sig_t = sig_t + model.sig_eta
        # update through the nonlinear observation model
        m_y, sig_y, sig_xy = moments(sp, model.observe, mu_t, sig_t)
        sig_y = sig_y + model.sig_zeta
        L = gain(sig_y, sig_xy)
        mu = mu_t + mv(L, ys[..., t, :] - m_y)
        sig = sig_t - L @ sig_y @ mT(L)
        sig = 0.5 * (sig + mT(sig))
        mu_f.append(mu)
        sig_f.append(sig)
        mu_p.append(mu_t)
        sig_p.append(sig_t)
    return stack_filter(mu0, sig0, mu_f, sig_f, mu_p, sig_p)


def ukf_smoother(model: UKFModel, sp: SigmaPoints, fr: FilterResult, us) -> SmootherResult:
    """Unscented RTS smoother: cross-covariances from sigma points."""

    def cross_at(t):
        u = us[..., t, :]
        return moments(sp, lambda pts: model.dynamics(pts, u), fr.mu_filt[..., t, :],
                       fr.sig_filt[..., t, :, :])[2]

    return rts_pass(fr, cross_at)


def make_pendulum_ukf(process_std: float = 1e-2, obs_std: float = 1e-2,
                      damping: float = 0.5, device="cuda") -> UKFModel:
    """A damped-pendulum system with sin/cos observations, batch-safe."""
    device = resolve_device(device)
    dt, m, l, g, u_mx = 0.05, 1.0, 1.0, 9.80665, 2.0

    def dynamics(pts, u):
        torque = torch.clamp(u[..., 0], -u_mx, u_mx)[..., None]
        th, thdot = pts[..., 0], pts[..., 1]
        thddot = (
            -3.0 * g / (2 * l) * torch.sin(th + math.pi)
            - damping * thdot
            + 3.0 / (m * l**2) * torque
        )
        new_thdot = thdot + thddot * dt
        new_th = th + new_thdot * dt
        return torch.stack([new_th, new_thdot], dim=-1)

    def observe(pts):
        return torch.stack([torch.sin(pts[..., 0]), torch.cos(pts[..., 0])], dim=-1)

    eye = torch.eye(2, dtype=torch.float32, device=device)
    return UKFModel(dynamics, observe, process_std**2 * eye, obs_std**2 * eye)


def default_sigma_points(dim: int = 2, device="cuda") -> SigmaPoints:
    """The reference's construction: sigma points with (α, β, κ) = (1, 0, 0)."""
    return make_sigma_points(1.0, 0.0, 0.0, dim, device)
