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
card (their plain versions on the CPU), for every augmented state and
feature size, as the reference's kernels take every size; a per-scenario
goal (B, T, Z) is refused and needs ``use_fused=False``, which runs the
per-step ``_kf_rts`` form.
The reference's ``pallas_smoother`` switch resolves as there: ``None`` and
``True`` leave the smoother to ``use_fused``, and an explicit ``False`` runs
``_kf_rts``, ``use_fused=True`` included. ``solve`` is ``solve_batch`` on a
batch of one without the kernels.

``solve_batch`` runs the solve as a list of stages (``_stages``) and marks
each iteration's with ``utils.profiling.span`` (no-ops unless the profiler
runs): ``i2c.linearize`` (the nominal rollout, the linearisation and the
smoother's inputs), ``i2c.smooth`` (the filter and smoother) and
``i2c.linesearch`` (the candidates, their rollout and the choice). The
failure guard and clip between them lie in no span; R, the prior
covariances and the action box are made once a solve, before the stages.

With ``cuda_graph=True`` a fused solve on the card without planning-model
noise is captured once per shape, one CUDA graph a stage
(``_StageGraphs``), and replayed under the same spans: the same launches in
the same order, so the same plans to the bit, without the host issuing
each of the solve's thousands of small launches.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..ops.i2c_smooth import i2c_smooth_batch
from ..ops.linearize import _transform_jacobian, linearize_dynamics, mT, mv
from ..ops.rollout import best_plan_by_rollout_cost, rollout, rollout_noisy
from ..utils.profiling import span
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
    # the reference's switch for its smoother kernels: False runs the plain
    # ``_kf_rts`` whatever ``use_fused`` asks for (None and True: as
    # ``use_fused`` says; the tensors' device then chooses between a kernel
    # and its plain version)
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
    # the port's own: replay the fused solve on the card as CUDA graphs
    # (see _StageGraphs); False, and any run that draws planning-model
    # noise, issues each launch from the host
    cuda_graph: bool = False

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

    def has_kernel_stages(self) -> bool:
        """Whether ``pallas_smoother`` allows the smoother kernels, which
        take every model (any D and Z)."""
        return self.pallas_smoother is not False

    def _check_fused(self, g_z) -> None:
        """Gate of ``use_fused=True``: the smoother kernels take one goal
        trajectory (T, Z) for the whole batch, as the reference's batching
        rule sends only a shared goal to its kernel. A per-scenario goal is
        refused here, on any device, so that a fused solve never runs the
        plain form unasked. Every D, Z and action size passes."""
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

    def _smooth(self, chain, R, covs, g_z, use_fused: bool):
        """Smoothed means (..., T, D) of a chain from ``_smoother_inputs``;
        with ``use_fused`` (one batch dimension, ``covs`` the prior
        covariances) through ``i2c_smooth_batch``."""
        F, m, J, z0, mu0 = chain
        if use_fused:
            return i2c_smooth_batch(F, m, J.contiguous(), z0.contiguous(), R, mu0.contiguous(),
                                    *covs, g_z)
        return self._kf_rts(F, m, J, z0, R, mu0, g_z)

    def _smooth_once(self, x0, us, g_z, alpha, xnoise=None, use_fused: bool = False):
        """Smoothed control means (..., T, A) of one iteration at
        temperature alpha."""
        chain = self._smoother_inputs(x0, us, g_z, xnoise)
        covs = self._prior_covs(us.device) if use_fused else None
        mu_smooth = self._smooth(chain, self._obs_noise(alpha, us.device), covs, g_z, use_fused)
        return mu_smooth[..., self.model.state_size:]

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
    def _stages(self, xs, g_z, use_fused: bool, noise=None) -> list:
        """The solve of xs (B, S) as its steps in order, each ``(span name or
        None, step)``; a step takes and returns the carried tensors: ``(us,)``
        between iterations, ``(us, chain)`` after the linearisation and
        ``(us, us_new)`` after the smoother. ``noise`` (max_iter, B, T, S)
        perturbs the nominal rollouts. R, the prior covariances and the
        action box are made here, so that no step copies from the host."""
        model, S, device = self.model, self.model.state_size, xs.device
        covs = self._prior_covs(device) if use_fused else None
        lo, hi = model.lo(device), model.hi(device)
        # the candidates of a per-scenario goal broadcast over their own axis
        g_cand = g_z if g_z.ndim == 2 else g_z[:, None]

        def guard(carry):
            # failure guard (cf. iLQR's Cholesky-NaN handling): if a
            # scenario's smoother diverges (inf linearization Jacobians at
            # far-out-of-envelope states under heavy model noise), it keeps
            # its previous plan instead of adopting a NaN one; then the clip
            us, us_new = carry
            finite = torch.isfinite(us_new).flatten(1).all(dim=1)
            return us, torch.clamp(torch.where(finite[:, None, None], us_new, us), lo, hi)

        def line_search(carry):
            # backtracked acceptance on the true rollout cost: the smoother
            # optimizes a moment-matched surrogate and can walk uphill in
            # true cost (on pendulum swing-up the surrogate's fixed point at
            # T >= 25 is a swing-damping plan; cf. SQP's line search). On LQ
            # problems the full step always wins and the fixed point is
            # unchanged.
            us, us_new = carry
            cands = torch.stack([us + g * (us_new - us) for g in self.ls_steps], dim=1)
            return (best_plan_by_rollout_cost(model, xs, g_cand, cands),)

        stages = []
        for i, alpha in enumerate(self.alphas()):
            R = self._obs_noise(alpha, device)
            xnoise = None if noise is None else self.model_noise_std * noise[i]
            stages += [
                ("i2c.linearize",
                 lambda c, xnoise=xnoise: (c[0], self._smoother_inputs(xs, c[0], g_z, xnoise))),
                ("i2c.smooth",
                 lambda c, R=R: (c[0], self._smooth(c[1], R, covs, g_z, use_fused)[..., S:])),
                (None, guard),
                ("i2c.linesearch", line_search) if self.line_search else (None, lambda c: c[1:])]
        return stages

    def solve_batch(self, state: I2CState, xs, g_z, use_fused: bool = True, noise=None):
        """One I2C solve for B scenarios xs (B, S), plans (B, T, A): all
        ``max_iter`` iterations in lock-step. With ``model_noise_std > 0``
        iteration i's nominal rollout gets ``model_noise_std``·noise[i],
        noise a standard-normal (max_iter, B, T, S) tensor, drawn from the
        state's generator unless given."""
        B = xs.shape[0]
        use_fused = use_fused and self.pallas_smoother is not False
        if use_fused:
            self._check_fused(g_z)
        if self.model_noise_std > 0.0:
            shape = (self.max_iter, B, self.T, self.model.state_size)
            if noise is None:
                noise = torch.randn(shape, generator=state.generator, device=xs.device)
            elif tuple(noise.shape) != shape:
                raise ValueError(f"noise has shape {tuple(noise.shape)}, expected {shape}")
        else:
            noise = None
            if use_fused and self.cuda_graph and xs.is_cuda:
                us = self._graphs_for(xs, state.planned_us, g_z)(xs, state.planned_us, g_z)
                return state._replace(planned_us=us), us[:, 0], {}
        carry = (state.planned_us,)
        for name, step in self._stages(xs, g_z, use_fused, noise):
            with span(name) if name else _NO_SPAN:
                carry = step(carry)
        us = carry[0]
        return state._replace(planned_us=us), us[:, 0], {}

    def _graphs_for(self, xs, us, g_z) -> "_StageGraphs":
        """The captured solve of these shapes, captured on first use."""
        graphs = self.__dict__.setdefault("_graphs", {})  # the frozen instance's own cache
        key = (xs.device, tuple(xs.shape), tuple(us.shape), tuple(g_z.shape))
        if key not in graphs:
            graphs[key] = _StageGraphs(self, xs, us, g_z)
        return graphs[key]

    def solve(self, state: I2CState, x, g_z, noise=None):
        """One I2C solve from state x (S,), plan (T, A): ``solve_batch`` on a
        batch of one without the kernels (``noise`` (max_iter, T, S))."""
        st, u0, aux = self.solve_batch(
            state._replace(planned_us=state.planned_us[None]), x[None], g_z, use_fused=False,
            noise=None if noise is None else noise[:, None])
        return state._replace(planned_us=st.planned_us[0]), u0[0], aux


_NO_SPAN = contextlib.nullcontext()


class _StageGraphs:
    """A fused I2C solve of one shape on the card as CUDA graphs, one a step
    of ``I2C._stages``: captured in order into one memory pool after an
    eager pass (which loads the kernels and fills their caches), and
    replayed in that order, each under its span. A call copies its inputs
    into the tensors the graphs read and returns a copy of the plans they
    write."""

    def __init__(self, solver: I2C, xs, us, g_z):
        self.xs, self.us, self.g_z = xs.clone(), us.clone(), g_z.clone()
        self.stages = solver._stages(self.xs, self.g_z, True)
        side = torch.cuda.Stream(xs.device)
        side.wait_stream(torch.cuda.current_stream(xs.device))
        with torch.cuda.stream(side):
            carry = (self.us,)
            for _, step in self.stages:
                carry = step(carry)
        torch.cuda.current_stream(xs.device).wait_stream(side)
        self.graphs, carry, pool = [], (self.us,), None
        for name, step in self.stages:
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=pool):
                carry = step(carry)
            pool = graph.pool()
            self.graphs.append((name, graph))
        self.out = carry[0]

    def __call__(self, xs, us, g_z):
        self.xs.copy_(xs)
        self.us.copy_(us)
        self.g_z.copy_(g_z)
        for name, graph in self.graphs:
            with span(name) if name else _NO_SPAN:
                graph.replay()
        return self.out.clone()
