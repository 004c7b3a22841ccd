"""SQP nonlinear MPC: repeated linearize → Riccati QP → line search.

Counterpart of ``benchmarking_mpc_solvers_tpu/solvers/sqp.py``. Each SQP
iteration:

1. linearizes the dynamics and Gauss-Newton-quadratizes the cost around the
   current trajectory (``ops/linearize.py``, or ``ops/fused_derivs.py`` in
   one launch),
2. solves the time-varying LQR subproblem in deviation coordinates (residual
   c = 0) with a Levenberg-style ``reg`` added to R,
3. rolls out the feedback step for all ``n_alphas`` step sizes 0.5^i at
   once, controls clipped to the box, the terminal cost included,
4. accepts the best candidate if it improves by more than ``tol``·|cost|;
   ``reg`` goes down by ``reg_factor`` on acceptance and up on rejection,
   and a scenario that did not improve is done.

The nominal rollout runs once; afterwards the accepted candidate's own
trajectory replaces it. ``solve_batch`` runs B scenarios in lock-step for
``max_iter`` iterations, each with its own cost, ``reg`` and ``done`` flag
(the reference gets the same from ``vmap`` of its scalar solve with
``custom_vmap`` rules; here the batch is written out). There is no early
exit and no host sync inside the loop. With ``use_fused`` (the reference's
``pallas_backward``) an iteration is one launch each of ``fused_derivs``, ``riccati_backward_batch``
(``with_c=True, check_pd=False``) and ``fused_linesearch``
(``with_terminal=True, return_states=True``) on the card, their plain
versions on the CPU; a model or a per-scenario goal (B, T, Z) that these do
not take is refused (``solvers/base.py:check_fused_tier``) and needs
``use_fused=False``. ``solve`` is ``solve_batch`` on a batch of one without
the kernels.

With ``parallel_horizon`` the subproblem is solved by the associative-scan
Riccati (``ops/riccati.py:tvlqr_backward_assoc_general``, plain PyTorch) on
either tier.

With ``model_noise_std > 0`` (the reference's ``_solve_noisy``) every
iteration draws fresh additive state noise for its nominal rollout and for
each line-search candidate, so no trajectory carries over: the nominal
rollout runs each iteration, the subproblem linearizes cleanly at its noisy
points (through the kernels with ``use_fused``, as the reference's vmapped
solve does), and the candidates roll out plain, as they do in the
reference. The reference's ``pallas_backward`` switch resolves as there:
``None`` and ``True`` leave the stages to ``use_fused``, and an explicit
``False`` runs every stage plain, ``use_fused=True`` included.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from ..device import resolve_device
from ..ops.fused_derivs import fused_derivs
from ..ops.fused_linesearch import fused_linesearch
from ..ops.linearize import (
    AffineDynamics,
    QuadCost,
    gn_terminal_terms,
    linearize_dynamics,
    mv,
    quadratize_cost,
)
from ..ops.riccati import TVLQRPolicy, tvlqr_backward, tvlqr_backward_assoc_general
from ..ops.riccati_backward import tvlqr_backward_cv
from ..ops.rollout import simulate_trajectory, simulate_trajectory_noisy
from .base import Solver, check_fused_tier, fused_tier_applicable, model_noise_draws


class SQPState(NamedTuple):
    planned_us: torch.Tensor  # (T, A), or (B, T, A) on the batched tier
    generator: torch.Generator


@dataclasses.dataclass(frozen=True, eq=False)
class SQP(Solver):
    max_iter: int = 10
    reg_init: float = 1e-2
    reg_min: float = 1e-8
    reg_max: float = 1e4
    reg_factor: float = 10.0
    n_alphas: int = 8
    tol: float = 1e-6
    model_noise_std: float = 0.0
    parallel_horizon: bool = False
    # init_std > 0 draws the initial plan ~ N(0, init_std) (clipped to the
    # box) instead of zeros: the swing-up tasks start at symmetric
    # equilibria where a zero plan has zero gradient. 0 keeps solves
    # deterministic.
    init_std: float = 0.0
    # the reference's kernel switch: False runs the plain stages whatever
    # ``use_fused`` asks for (None and True: as ``use_fused`` says)
    pallas_backward: Optional[bool] = None

    # -- state ----------------------------------------------------------------
    def init_state(self, generator: torch.Generator, device="cuda", noise=None) -> SQPState:
        device = resolve_device(device)
        return SQPState(self._init_plan((), self.init_std, generator, device, noise), generator)

    def init_state_batch(self, batch: int, generator: torch.Generator, device="cuda",
                         noise=None) -> SQPState:
        device = resolve_device(device)
        return SQPState(self._init_plan((batch,), self.init_std, generator, device, noise),
                        generator)

    def has_kernel_stages(self) -> bool:
        """Whether ``pallas_backward`` allows the kernels and the
        derivative, Riccati and line-search kernels take the model
        (``solvers/base.py:fused_tier_applicable``)."""
        return self.pallas_backward is not False and fused_tier_applicable(self.model)

    def alphas(self, device=None):
        """Line-search step sizes 0.5^i, i < n_alphas, in float32."""
        return 0.5 ** torch.arange(self.n_alphas, dtype=torch.float32, device=device)

    # -- one iteration's stages ---------------------------------------------------
    def _subproblem(self, xs, us, g_z, reg, use_fused: bool = False) -> TVLQRPolicy:
        """Gauss-Newton TV-LQR step in deviation coordinates for B
        trajectories xs (B, T+1, S), us (B, T, A) with per-scenario reg (B,);
        returns the affine deviation policy δu = K δx + k."""
        model = self.model
        if use_fused:
            check_fused_tier("SQP._subproblem", model, g_z)
            A, Bd, c, Q, R, M, q, r = fused_derivs(model, xs.contiguous(), us.contiguous(), g_z)
            qf, Qf = gn_terminal_terms(model, xs[:, -1], g_z[-1])
            dyn, cost = AffineDynamics(A, Bd, c), QuadCost(Q, R, M, q, r, Qf, qf)
        else:
            dyn = linearize_dynamics(model, xs[:, :-1], us)
            cost = quadratize_cost(model, xs, us, g_z, gauss_newton=True)
        # deviation dynamics are homogeneous (residual c = 0 at the rollout)
        dyn = dyn._replace(c=torch.zeros_like(dyn.c))
        eye = torch.eye(model.action_size, dtype=torch.float32, device=xs.device)
        cost = cost._replace(R=cost.R + reg[:, None, None, None] * eye)
        if self.parallel_horizon:
            return tvlqr_backward_assoc_general(dyn, cost)
        if use_fused:
            return tvlqr_backward_cv(dyn, cost)
        return tvlqr_backward(dyn, cost, reg=0.0)

    def _try_step(self, alphas, policy: TVLQRPolicy, xs, us, g_z, xnoise=None):
        """Closed-loop forward application of the deviation policy for all
        step sizes alphas (n,): ``(us_new (n, B, T, A), xs_new (n, B, T+1, S),
        cost (n, B))``, the terminal cost included. The realized
        trajectories travel back so the accepted one is adopted without
        re-simulating. ``xnoise`` (n, B, T, S) is added to the state after
        each step (the noisy planning model)."""
        model = self.model
        n = alphas.shape[0]
        B, T, _ = us.shape
        x = xs[:, 0].expand(n, B, xs.shape[-1])
        cost = torch.zeros((n, B), dtype=torch.float32, device=xs.device)
        alpha = alphas[:, None, None]
        xs_new, us_new = [x], []
        for t in range(T):
            u = us[:, t] + alpha * policy.k[:, t] + mv(policy.K[:, t], x - xs[:, t])
            u = model.clip_action(u)
            x, c = model.step_and_cost(x, u, g_z[..., t, :])
            if xnoise is not None:
                x = x + xnoise[:, :, t]
            cost = cost + c
            xs_new.append(x)
            us_new.append(u)
        cost = cost + model.final_cost(x, g_z[..., -1, :])
        return torch.stack(us_new, dim=2), torch.stack(xs_new, dim=2), cost

    # -- outer loop ---------------------------------------------------------------
    def solve_batch(self, state: SQPState, xs, g_z, use_fused: bool = True, noise=None):
        """One SQP solve for B scenarios xs (B, S), plans (B, T, A): all
        ``max_iter`` iterations in lock-step, a scenario frozen once it
        stops improving. With ``model_noise_std > 0`` each iteration draws
        standard normals (B, T, S) for its nominal rollout and
        (B, n_alphas, T, S) for the candidates from the state's generator
        (``noise``, a pair of such draws with a leading ``max_iter`` axis,
        replaces them), rolls the plan out noisily, solves the subproblem at
        the noisy trajectory and takes the best noisy candidate, rolled out
        plain."""
        model = self.model
        x0s = xs
        B = x0s.shape[0]
        us = state.planned_us
        alphas = self.alphas(x0s.device)
        reg = torch.full((B,), self.reg_init, dtype=torch.float32, device=x0s.device)
        done = torch.zeros((B,), dtype=torch.bool, device=x0s.device)
        rows = torch.arange(B, device=x0s.device)
        use_fused = use_fused and self.pallas_backward is not False
        if use_fused:
            check_fused_tier("SQP.solve_batch", model, g_z)
        draws = model_noise_draws(self, state.generator, B, x0s.device, noise)
        noisy = self.model_noise_std > 0.0
        if not noisy:  # afterwards the accepted candidate's trajectory
            traj, cost = self._nominal(x0s, us, g_z)
        for i in range(self.max_iter):
            nz = draws(i)
            if noisy:  # no trajectory carries over: roll out anew
                traj, cost = self._nominal(x0s, us, g_z, self.model_noise_std * nz[0])
            policy = self._subproblem(traj, us, g_z, reg, use_fused)
            if noisy:
                cand_us, cand_xs, cand_costs = self._try_step(
                    alphas, policy, traj, us, g_z, self.model_noise_std * nz[1].transpose(0, 1))
            elif use_fused:
                cand_us, cand_xs, cand_costs = fused_linesearch(
                    model, alphas, traj[:, 0].contiguous(), us.contiguous(),
                    policy.k.contiguous(), policy.K.contiguous(), traj.contiguous(), g_z,
                    with_terminal=True, return_states=True)
            else:
                cand_us, cand_xs, cand_costs = self._try_step(alphas, policy, traj, us, g_z)
            best = torch.argmin(cand_costs, dim=0)  # first minimum, as argmin
            best_cost = cand_costs[best, rows]
            improved = best_cost < cost - self.tol * torch.abs(cost)
            accept = improved & ~done
            us = torch.where(accept[:, None, None], cand_us[best, rows], us)
            traj = torch.where(accept[:, None, None], cand_xs[best, rows], traj)
            cost = torch.where(accept, best_cost, cost)
            reg = torch.where(accept,
                              torch.clamp(reg / self.reg_factor, min=self.reg_min),
                              torch.clamp(reg * self.reg_factor, max=self.reg_max))
            done = done | ~improved
        us = model.clip_action(us)
        return state._replace(planned_us=us), us[:, 0], {}

    def _nominal(self, x0s, us, g_z, xnoise=None):
        """The plans' rollout (noisy with ``xnoise`` (B, T, S)) and its
        cost, the terminal cost included."""
        if xnoise is None:
            traj, cost = simulate_trajectory(self.model, x0s, us, g_z)
        else:
            traj, cost = simulate_trajectory_noisy(self.model, x0s, us, g_z, xnoise)
        return traj, cost + self.model.final_cost(traj[:, -1], g_z[..., -1, :])

    def solve(self, state: SQPState, x, g_z):
        """One SQP solve from state x (S,), plan (T, A): ``solve_batch`` on
        a batch of one, without the kernels."""
        st, u0, aux = self.solve_batch(state._replace(planned_us=state.planned_us[None]),
                                       x[None], g_z, use_fused=False)
        return state._replace(planned_us=st.planned_us[0]), u0[0], aux
