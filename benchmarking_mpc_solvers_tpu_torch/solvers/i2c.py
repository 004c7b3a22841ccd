"""i2c — Input Inference for Control (optimal control as Gaussian inference).

Counterpart of ``benchmarking_mpc_solvers_tpu/solvers/i2c.py``: the
linear-Gaussian i2c recursion (Watson, Abdulsamad & Peters' input-inference
formulation), trajectory optimization as iterated Bayesian smoothing.

Formulation per iteration, around the current nominal (x̄, ū):

- augmented latent ξ_t = (x_t, u_t) with dynamics prior
      ξ_{t+1} = F_t ξ_t + m_t + w,  F_t = [[A_t, B_t], [0, 0]],
      m_t = (c_t, ū_t),  w ~ N(0, blockdiag(εI, Σ_u)),
  i.e. the control is an independent latent with prior N(ū_t, Σ_u)
  (linearization A_t, B_t, c_t from ``ops/linearize``).
- "optimality" pseudo-observation of the cost features:
      y_t = g_t observed through z(ξ) ≈ J_t ξ + z0_t with Gaussian noise
      R = (2α W̃)⁻¹,  W̃ = W + εI — the exp(−α·cost) likelihood moment-matched
      at the linearization point; α is the annealing temperature.
- a time-varying Kalman filter + RTS smoother over ξ gives the posterior;
  the smoothed control means become the next nominal: ū ← E[u | y=g].

As α → ∞ on an LQ problem the fixed point is the LQR optimum; on nonlinear
systems the iteration is a Gauss-Newton-like method with built-in
exploration covariances.

``solve_batch`` is the reference's ``vmap`` of ``solve`` written out over the
batch: B scenarios in lock-step for ``max_iter`` iterations, no early exit
and no host sync inside the loop. With ``use_fused`` an iteration's filter
and smoother are one launch each of ``ops/i2c_smooth.py``'s kernels on the
card (their plain versions on the CPU); a per-scenario goal (B, T, Z), or an
augmented state or feature size the kernels do not hold, is refused and
needs ``use_fused=False``, which runs the per-step ``_kf_rts`` form.
``solve`` is ``solve_batch`` on a batch of one without the kernels.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..ops.i2c_smooth import MAX_DIM, i2c_smooth_batch
from ..ops.linearize import _transform_jacobian, linearize_dynamics, mT, mv
from ..ops.rollout import best_plan_by_rollout_cost, rollout, rollout_noisy
from .base import Solver


class I2CState(NamedTuple):
    planned_us: torch.Tensor  # (T, A) nominal controls, or (B, T, A) on the batched tier
    generator: torch.Generator


def _solve(A, b):
    """A⁻¹ b without the host-side singularity check of ``linalg.solve``: a
    non-finite system gives a non-finite answer for the caller's failure
    guard instead of raising, and there is no device sync."""
    return torch.linalg.solve_ex(A, b).result


@dataclasses.dataclass(frozen=True, eq=False)
class I2C(Solver):
    max_iter: int = 10
    alpha0: float = 1.0  # initial optimality temperature
    anneal: float = 1.5  # per-iteration temperature growth
    alpha_max: float = 100.0  # cap: in f32 the (2αW)⁻¹ observation noise
    # degenerates past ~1e2 and the smoother walks away from the optimum
    sigma_u: float = 0.5  # control prior std
    eps_w: float = 1e-5  # cost-weight ridge (W is usually singular)
    eps_x: float = 1e-6  # state process-noise floor
    # planning-model noise: the nominal rollout the smoother linearizes
    # around gets additive state noise
    model_noise_std: float = 0.0
    # The reference's switch for its smoother kernels (None = on its own
    # accelerator only). Kept for the reader who looks for it; it has no
    # effect here: ``solve_batch(use_fused=...)`` chooses the tier, and the
    # tensors' device chooses between a kernel and its plain version.
    pallas_smoother: Optional[bool] = None
    # init_std > 0: random initial plan ~ N(0, init_std) clipped to the box
    # (symmetric-equilibrium escape, cf. sqp.py init_std). Default 0 = zeros
    # (deterministic).
    init_std: float = 0.0
    # backtracked acceptance of each smoothing step on the true rollout
    # cost; candidate step sizes along (us_new - us), 0.0 = keep the old
    # plan. See solve_batch().
    line_search: bool = True
    ls_steps: tuple = (1.0, 0.5, 0.0)
    # prior_lag=True sets the control-prior mean carried by m_t to ū_t
    # instead of ū_{t+1} (see _smooth_once): the one-step lag phase-shifts
    # the prior against oscillatory plans and acts as control-rate damping.
    # On pendulum swing-up that damping kills energy pumping, but on
    # cartpole swing-up — where the optimal plan rides the ±1 actuation box
    # and the x^10 track-edge cost punishes overshoot — it stabilizes
    # long-horizon MPC.
    prior_lag: bool = False

    # -- state ----------------------------------------------------------------
    def init_state(self, generator: torch.Generator, device="cuda", noise=None) -> I2CState:
        device = resolve_device(device)
        return I2CState(self._init_plan((), self.init_std, generator, device, noise), generator)

    def init_state_batch(self, batch: int, generator: torch.Generator, device="cuda",
                         noise=None) -> I2CState:
        device = resolve_device(device)
        return I2CState(self._init_plan((batch,), self.init_std, generator, device, noise),
                        generator)

    # -- constants --------------------------------------------------------------
    def alphas(self) -> list:
        """The temperature of each iteration, annealed in float32 as the
        reference's carry is."""
        alpha, out = np.float32(self.alpha0), []
        for _ in range(self.max_iter):
            out.append(alpha)
            alpha = min(np.float32(alpha * np.float32(self.anneal)), np.float32(self.alpha_max))
        return out

    def _obs_noise(self, alpha, device=None):
        """R = (2α (W + ε_w I))⁻¹ (Z, Z), the same for the whole batch. The
        inverse is taken on the host: it is outside the reference's kernels
        too."""
        W = torch.as_tensor(self.model.state_cost.W, dtype=torch.float32)
        Wt = W + self.eps_w * torch.eye(W.shape[0], dtype=torch.float32)
        R = torch.linalg.inv(float(np.float32(2.0) * np.float32(alpha)) * Wt)
        return R.contiguous().to(device)  # inv hands back a transposed layout

    def _prior_covs(self, device=None):
        """(sig0, Q_proc) from the static solver constants."""
        S, A = self.model.state_size, self.model.action_size
        D = S + A
        Q_proc = torch.zeros((D, D), dtype=torch.float32)
        Q_proc[:S, :S] = self.eps_x * torch.eye(S)
        Q_proc[S:, S:] = self.sigma_u**2 * torch.eye(A)
        sig0 = torch.zeros((D, D), dtype=torch.float32)
        sig0[:S, :S] = 1e-8 * torch.eye(S)
        sig0[S:, S:] = self.sigma_u**2 * torch.eye(A)
        return sig0.to(device), Q_proc.to(device)

    def _check_fused(self, g_z) -> None:
        """Gate of ``use_fused=True``: the smoother kernels take one goal
        trajectory (T, Z) for the whole batch and D, Z up to ``MAX_DIM``.
        Anything else is refused here, on any device, so that a fused solve
        never runs the plain form unasked. Any action size passes."""
        D = self.model.state_size + self.model.action_size
        Z = self.model.state_cost.W.shape[0]
        if D > MAX_DIM or Z > MAX_DIM:
            raise NotImplementedError(
                f"I2C.solve_batch(use_fused=True) needs state_size + action_size and the "
                f"feature size <= {MAX_DIM}, got {D} and {Z}; pass use_fused=False")
        if g_z.ndim != 2:
            raise NotImplementedError(
                f"I2C.solve_batch(use_fused=True) needs one goal trajectory (T, Z) shared by "
                f"the batch, got g_z of shape {tuple(g_z.shape)}; pass use_fused=False")

    # -- one smoothing iteration ------------------------------------------------
    def _smoother_inputs(self, x0, us, g_z, xnoise=None):
        """The linear-Gaussian chain around the nominal rollout of us
        (..., T, A) from x0 (..., S): ``(F (..., T, D, D), m (..., T, D),
        J (..., T, Z, D), z0 (..., T, Z), mu0 (..., D))``. ``xnoise``
        (..., T, S) is added to the rollout's states."""
        model = self.model
        S = model.state_size
        D = S + model.action_size
        lead = us.shape[:-1]

        if xnoise is None:
            xs, _ = rollout(model, x0, us, g_z)
        else:
            xs, _ = rollout_noisy(model, x0, us, g_z, xnoise)
        x_pts = xs[..., :-1, :]
        dyn = linearize_dynamics(model, x_pts, us)

        # feature observation model z(ξ) ≈ J ξ + z0 at the nominal
        xu = torch.cat([x_pts, us], dim=-1).reshape(-1, D)
        z, J = _transform_jacobian(model, xu)
        Z = z.shape[-1]
        z0 = (z - mv(J, xu)).reshape(lead + (Z,))
        J = J.reshape(lead + (Z, D))

        F = torch.zeros(lead + (D, D), dtype=torch.float32, device=us.device)
        F[..., :S, :S] = dyn.A
        F[..., :S, S:] = dyn.B
        # predict step t produces ξ_{t+1}, so the control-prior mean carried
        # by m_t is ū_{t+1} (last row repeats ū_{T-1}; that prediction is
        # unobserved). prior_lag=True uses ū_t instead: a one-step lag that
        # damps oscillatory plans (see the field comment).
        if self.prior_lag:
            us_prior = us
        else:
            us_prior = torch.cat([us[..., 1:, :], us[..., -1:, :]], dim=-2)
        m = torch.cat([dyn.c, us_prior], dim=-1)  # (..., T, D)

        # prior at t=0: x0 known (tight), u_0 ~ N(ū_0, Σ_u)
        mu0 = torch.cat([xs[..., 0, :], us[..., 0, :]], dim=-1)
        return F, m, J, z0, mu0

    def _smooth_once(self, x0, us, g_z, alpha, xnoise=None, use_fused: bool = False):
        """Smoothed control means (..., T, A) of one iteration at
        temperature alpha; with ``use_fused`` (one batch dimension) through
        ``i2c_smooth_batch``."""
        S = self.model.state_size
        F, m, J, z0, mu0 = self._smoother_inputs(x0, us, g_z, xnoise)
        R = self._obs_noise(alpha, us.device)
        if use_fused:
            sig0, Q_proc = self._prior_covs(us.device)
            mu_smooth = i2c_smooth_batch(F, m, J.contiguous(), z0.contiguous(), R,
                                         mu0.contiguous(), sig0, Q_proc, g_z)
        else:
            mu_smooth = self._kf_rts(F, m, J, z0, R, mu0, g_z)
        return mu_smooth[..., S:]

    def _kf_rts(self, F, m, Js, z0s, R, mu0, g_z):
        """Forward KF + backward RTS over the augmented chain, the plain
        per-step form over any leading batch dimensions; returns smoothed
        means (..., T, D)."""
        sig0, Q_proc = self._prior_covs(F.device)
        T = F.shape[-3]

        # forward filter over t = 0..T-1 (observation then predict)
        mu_p, sig_p = mu0, sig0
        mu_f, sig_f, mu_pred, sig_pred = [], [], [], []
        for t in range(T):
            F_t, J_t = F[..., t, :, :], Js[..., t, :, :]
            sig_y = J_t @ sig_p @ mT(J_t) + R
            L = mT(_solve(mT(sig_y), mT(sig_p @ mT(J_t))))
            mu_t = mu_p + mv(L, g_z[..., t, :] - (mv(J_t, mu_p) + z0s[..., t, :]))
            sig_t = sig_p - L @ J_t @ sig_p
            sig_t = 0.5 * (sig_t + mT(sig_t))
            mu_p = mv(F_t, mu_t) + m[..., t, :]
            sig_p = F_t @ sig_t @ mT(F_t) + Q_proc
            mu_f.append(mu_t)
            sig_f.append(sig_t)
            mu_pred.append(mu_p)
            sig_pred.append(sig_p)

        # backward RTS over the augmented chain
        mu_next, sig_next = mu_f[-1], sig_f[-1]
        mu_s = [None] * T
        mu_s[-1] = mu_next
        for t in reversed(range(T - 1)):
            G = mT(_solve(mT(sig_pred[t]), mT(sig_f[t] @ mT(F[..., t, :, :]))))
            mu_next = mu_f[t] + mv(G, mu_next - mu_pred[t])
            sig_next = sig_f[t] + G @ (sig_next - sig_pred[t]) @ mT(G)
            mu_s[t] = mu_next
        return torch.stack(mu_s, dim=-2)

    # -- outer loop ---------------------------------------------------------------
    def solve_batch(self, state: I2CState, xs, g_z, use_fused: bool = True, noise=None):
        """One I2C solve for B scenarios xs (B, S), plans (B, T, A): all
        ``max_iter`` iterations in lock-step. With ``model_noise_std > 0``
        iteration i's nominal rollout gets ``model_noise_std``·noise[i],
        noise a standard-normal (max_iter, B, T, S) tensor, drawn from the
        state's generator unless given."""
        model = self.model
        us = state.planned_us
        B = xs.shape[0]
        if use_fused:
            self._check_fused(g_z)
        if self.model_noise_std > 0.0:
            shape = (self.max_iter, B, self.T, model.state_size)
            if noise is None:
                noise = torch.randn(shape, generator=state.generator, device=xs.device)
            elif tuple(noise.shape) != shape:
                raise ValueError(f"noise has shape {tuple(noise.shape)}, expected {shape}")
        # the candidates of a per-scenario goal broadcast over their own axis
        g_cand = g_z if g_z.ndim == 2 else g_z[:, None]
        for i, alpha in enumerate(self.alphas()):
            xnoise = self.model_noise_std * noise[i] if self.model_noise_std > 0.0 else None
            us_new = self._smooth_once(xs, us, g_z, alpha, xnoise, use_fused)
            # failure guard (cf. iLQR's Cholesky-NaN handling): if a
            # scenario's smoother diverges (inf linearization Jacobians at
            # far-out-of-envelope states under heavy model noise), it keeps
            # its previous plan instead of adopting a NaN one
            finite = torch.isfinite(us_new).flatten(1).all(dim=1)
            us_new = torch.where(finite[:, None, None], us_new, us)
            us_new = model.clip_action(us_new)
            if self.line_search:
                # backtracked acceptance on the true rollout cost: the
                # smoother optimizes a moment-matched surrogate and can walk
                # uphill in true cost (on pendulum swing-up the surrogate's
                # fixed point at T >= 25 is a swing-damping plan; cf. SQP's
                # line search). On LQ problems the full step always wins and
                # the fixed point is unchanged.
                cands = torch.stack([us + g * (us_new - us) for g in self.ls_steps], dim=1)
                us_new = best_plan_by_rollout_cost(model, xs, g_cand, cands)
            us = us_new
        return state._replace(planned_us=us), us[:, 0], {}

    def solve(self, state: I2CState, x, g_z, noise=None):
        """One I2C solve from state x (S,), plan (T, A): ``solve_batch`` on a
        batch of one without the kernels (``noise`` (max_iter, T, S))."""
        st, u0, aux = self.solve_batch(
            state._replace(planned_us=state.planned_us[None]), x[None], g_z, use_fused=False,
            noise=None if noise is None else noise[:, None])
        return state._replace(planned_us=st.planned_us[0]), u0[0], aux
