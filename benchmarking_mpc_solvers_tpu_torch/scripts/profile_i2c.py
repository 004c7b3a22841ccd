"""Stage breakdown of the batched I2C solve at configuration 6 (pendulum,
T=25, B=256).

Counterpart of ``scripts/profile_i2c.py``, with its stage keys: the nominal
rollout, the dynamics' linearization, one smoothing iteration with the
smoother kernels (``smooth_iter_pallas``: kernels 8a and 8b on the card)
and with the plain filter and smoother (``smooth_iter_scan``), and the whole
solve (10 iterations) both ways; and besides, the smoother kernels alone on
one iteration's inputs (``smoother_kernels``: ``i2c_smooth_batch``), the
feature Jacobians (``jacobians``) and the three-candidate line search
(``line_search``: ``best_plan_by_rollout_cost``). Each is a chained paired
difference (``utils.device_step_latency``) over 8 inputs perturbed by
1e-6·N(0, 1), with its resolution; a stage at or below it is flagged.
Writes ``<results-dir>/measure/profile_i2c.json``.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ..device import resolve_device
from ..envs import PendulumEnv
from ..ops.i2c_smooth import i2c_smooth_batch
from ..ops.linearize import _transform_jacobian, linearize_dynamics
from ..ops.rollout import best_plan_by_rollout_cost, rollout
from ..solvers import I2C
from ._common import (
    chain_options, device_record, measure_parser, perturbations, stage_timer, write_measure)


def run(args) -> dict:
    device = resolve_device(args.device)
    q = args.quick
    env = PendulumEnv
    model = env.model
    T, B = (5, 4) if q else (25, 256)
    samples = args.samples or (2 if q else 10)
    g_z = torch.zeros((T, model.goal_size), device=device)
    S, A = model.state_size, model.action_size

    rng = np.random.default_rng(args.seed)
    x0s = (env.start_state(device).expand(B, -1) + torch.from_numpy(
        (1e-2 * rng.standard_normal((B, S))).astype(np.float32)).to(device)).contiguous()
    us0 = torch.from_numpy((0.1 * rng.standard_normal((B, T, A))).astype(np.float32)).to(device)

    stages = {}
    timed = stage_timer(stages, device, samples, chain_options(args))
    solver_on = I2C(model=model, T=T, max_iter=10, pallas_smoother=True)
    solver_off = I2C(model=model, T=T, max_iter=10, pallas_smoother=False)

    # the ~10 us stages: long chains, so the difference resolves
    deep = 160 if q else 8000
    dx0 = perturbations(x0s.shape, device)
    timed("rollout", lambda d: torch.sum(rollout(model, x0s + d, us0, g_z)[0]), dx0, max_hi=deep)
    xss, _ = rollout(model, x0s, us0, g_z)
    dxs = perturbations(xss.shape, device)
    timed("linearize", lambda d: torch.sum(linearize_dynamics(model, (xss + d)[:, :-1], us0).A),
          dxs, max_hi=deep)

    def jac(d):
        xu = torch.cat([(xss + d)[:, :-1], us0], dim=-1).reshape(-1, S + A)
        z, J = _transform_jacobian(model, xu)
        return torch.sum(z) + torch.sum(J)

    timed("jacobians", jac, dxs, max_hi=deep)

    for name, sv, fused in (("smooth_iter_pallas", solver_on, True),
                            ("smooth_iter_scan", solver_off, False)):
        timed(name, lambda d, sv=sv, fused=fused: torch.sum(sv._smooth_once(
            x0s + d, us0, g_z, sv.alphas()[0], use_fused=fused)), dx0,
            max_hi=160 if q else 2000)

    F, m, J, z0, mu0 = solver_on._smoother_inputs(x0s, us0, g_z)
    R = solver_on._obs_noise(solver_on.alphas()[0], device)
    sig0, Q_proc = solver_on._prior_covs(device)
    dm = perturbations(m.shape, device)
    timed("smoother_kernels", lambda d: torch.sum(i2c_smooth_batch(
        F, (m + d).contiguous(), J.contiguous(), z0.contiguous(), R, mu0.contiguous(), sig0,
        Q_proc, g_z)), dm, max_hi=160 if q else 2000)

    cands = torch.stack([us0 * g for g in solver_on.ls_steps], dim=1)  # (B, 3, T, A)
    timed("line_search", lambda d: torch.sum(best_plan_by_rollout_cost(
        model, x0s + d, g_z, cands)), dx0, max_hi=deep)

    gen = torch.Generator(device=device).manual_seed(args.seed)
    dx0_solve = perturbations(x0s.shape, device, scale=1e-3)
    for name, sv, fused in (("solve_x10iter_pallas", solver_on, True),
                            ("solve_x10iter_scan", solver_off, False)):
        def whole(d, sv=sv, fused=fused):
            state = sv.init_state_batch(B, gen, device)
            _, u0, _ = sv.solve_batch(state, (x0s + d).contiguous(), g_z, use_fused=fused)
            return torch.sum(u0)

        timed(name, whole, dx0_solve)

    return {"config": f"pendulum I2C T={T} B={B}", "device": device_record(device),
            "stage_ms": stages}


def main(argv=None) -> dict:
    args = measure_parser(__doc__).parse_args(argv)
    out = run(args)
    write_measure(args, "profile_i2c", out)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
