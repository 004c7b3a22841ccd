"""Linear-Gaussian Kalman filtering and RTS smoothing.

Counterpart of ``benchmarking_mpc_solvers_tpu/estimation/kalman.py``: the
estimation building blocks of the i2c solver family (predict with affine
dynamics Ax + a + Bu, update with a solve-based gain, backward RTS
smoothing) as passes over whole measurement sequences. Plain PyTorch,
float32, a Python loop over the sequence. Where the reference is vmapped
over batches of trajectories, the priors, controls and measurements here
take any leading batch dimensions; the model is shared.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.linearize import mT, mv


class LGSSM(NamedTuple):
    """Affine-Gaussian state-space model x' = Ax + a + Bu + w, y = Cx + v."""

    A: torch.Tensor  # (S, S)
    a: torch.Tensor  # (S,)
    B: torch.Tensor  # (S, U)
    C: torch.Tensor  # (Y, S)
    sig_eta: torch.Tensor  # (S, S) process noise cov
    sig_zeta: torch.Tensor  # (Y, Y) observation noise cov


class FilterResult(NamedTuple):
    mu_filt: torch.Tensor  # (..., N+1, S) filtered means incl. prior
    sig_filt: torch.Tensor  # (..., N+1, S, S)
    mu_pred: torch.Tensor  # (..., N, S) one-step predicted means
    sig_pred: torch.Tensor  # (..., N, S, S)


def gain(sig_y, cross):
    """``cross sig_y⁻¹`` as the reference writes it: solve(sig_yᵀ, crossᵀ)ᵀ."""
    return mT(torch.linalg.solve(mT(sig_y), mT(cross)))


def batch_prior(mu0, sig0, us, ys):
    """The prior over the leading batch dimensions of all four arguments, so
    that every moment of the result carries them."""
    lead = torch.broadcast_shapes(mu0.shape[:-1], sig0.shape[:-2], us.shape[:-2], ys.shape[:-2])
    return mu0.expand(lead + mu0.shape[-1:]), sig0.expand(lead + sig0.shape[-2:])


def stack_filter(mu0, sig0, mu_f, sig_f, mu_p, sig_p) -> FilterResult:
    """Per-step lists -> a ``FilterResult`` with the prior in front."""
    return FilterResult(
        torch.stack([mu0, *mu_f], dim=-2),
        torch.stack([sig0, *sig_f], dim=-3),
        torch.stack(mu_p, dim=-2),
        torch.stack(sig_p, dim=-3),
    )


def kalman_filter(model: LGSSM, mu0, sig0, us, ys) -> FilterResult:
    """Filter a sequence: us (..., N, U) controls, ys (..., N, Y)
    measurements, from the prior mu0 (..., S), sig0 (..., S, S)."""
    eye = torch.eye(model.A.shape[0], dtype=sig0.dtype, device=sig0.device)
    mu0, sig0 = batch_prior(mu0, sig0, us, ys)
    mu, sig = mu0, sig0
    mu_f, sig_f, mu_p, sig_p = [], [], [], []
    for t in range(us.shape[-2]):
        # predict
        mu_t = mv(model.A, mu) + model.a + mv(model.B, us[..., t, :])
        sig_t = model.A @ sig @ model.A.T + model.sig_eta
        # update
        sig_y = model.C @ sig_t @ model.C.T + model.sig_zeta
        L = gain(sig_y, sig_t @ model.C.T)
        mu = mu_t + mv(L, ys[..., t, :] - mv(model.C, mu_t))
        sig = (eye - L @ model.C) @ sig_t
        mu_f.append(mu)
        sig_f.append(sig)
        mu_p.append(mu_t)
        sig_p.append(sig_t)
    return stack_filter(mu0, sig0, mu_f, sig_f, mu_p, sig_p)


class SmootherResult(NamedTuple):
    mu_smooth: torch.Tensor  # (..., N+1, S)
    sig_smooth: torch.Tensor  # (..., N+1, S, S)


def rts_pass(fr: FilterResult, cross_at) -> SmootherResult:
    """Backward Rauch-Tung-Striebel pass over a filter's result;
    ``cross_at(t)`` gives the cross-covariance of x_t and x_{t+1} under the
    filtered moments of t, (..., S, S)."""
    N = fr.mu_pred.shape[-2]
    mu_next, sig_next = fr.mu_filt[..., N, :], fr.sig_filt[..., N, :, :]
    mu_s, sig_s = [None] * N + [mu_next], [None] * N + [sig_next]
    for t in reversed(range(N)):
        sig_p = fr.sig_pred[..., t, :, :]
        J = gain(sig_p, cross_at(t))
        mu_next = fr.mu_filt[..., t, :] + mv(J, mu_next - fr.mu_pred[..., t, :])
        sig_next = fr.sig_filt[..., t, :, :] + J @ (sig_next - sig_p) @ mT(J)
        mu_s[t], sig_s[t] = mu_next, sig_next
    return SmootherResult(torch.stack(mu_s, dim=-2), torch.stack(sig_s, dim=-3))


def rts_smoother(model: LGSSM, fr: FilterResult) -> SmootherResult:
    """Backward RTS pass of the linear model: cross-covariance sig_f Aᵀ."""
    return rts_pass(fr, lambda t: fr.sig_filt[..., t, :, :] @ model.A.T)


def kalman_smooth(model: LGSSM, mu0, sig0, us, ys) -> SmootherResult:
    return rts_smoother(model, kalman_filter(model, mu0, sig0, us, ys))
