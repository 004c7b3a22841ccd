"""Stage breakdown of the batched SQP iteration at configuration 4 (acrobot,
T=100, B=1,024), and the whole solve at several batch sizes.

Counterpart of ``scripts/profile_sqp.py``, with its stage keys: the nominal
rollout, the dynamics' linearization and the cost's Gauss-Newton
quadratization (every output summed), the subproblem (``SQP._subproblem``:
on the card kernel 4 for the derivatives and kernel 5 for the Riccati pass,
as ``solve_batch`` routes it), the subproblem with the 8-α line search
(kernel 6), the same two on the plain stages (``*_plain``), and the whole
solve (``solve_batch``) at max_iter 6, 4 and 2 and B 128 and 1,024. Each is
a chained paired difference (``utils.device_step_latency``) over 8 inputs
perturbed by 1e-6·N(0, 1). Writes ``<results-dir>/measure/profile_sqp.json``.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ..device import resolve_device
from ..envs import AcrobotEnv
from ..ops.fused_linesearch import fused_linesearch
from ..ops.linearize import linearize_dynamics, quadratize_cost
from ..ops.rollout import simulate_trajectory
from ..solvers import SQP
from ._common import (
    chain_options, device_record, measure_parser, perturbations, stage_timer, write_measure)

START = (0.1, 0.0, 0.2, 0.0)


def run(args) -> dict:
    device = resolve_device(args.device)
    q = args.quick
    env = AcrobotEnv
    model = env.model
    T, B = (5, 4) if q else (100, 1024)
    samples = args.samples or (2 if q else 10)
    solver = SQP(model=model, T=T, max_iter=6)
    g_z = torch.zeros((T, model.goal_size), device=device)
    S, A = model.state_size, model.action_size

    rng = np.random.default_rng(args.seed)
    start = torch.tensor(START, device=device)
    x0s = (start.expand(B, -1) + torch.from_numpy(
        (1e-2 * rng.standard_normal((B, S))).astype(np.float32)).to(device)).contiguous()
    us0 = torch.from_numpy((0.1 * rng.standard_normal((B, T, A))).astype(np.float32)).to(device)
    xss, _ = simulate_trajectory(model, x0s, us0, g_z)
    reg = torch.full((B,), 1e-2, device=device)

    stages = {}
    timed = stage_timer(stages, device, samples, chain_options(args))
    dx0, dxs = perturbations(x0s.shape, device), perturbations(xss.shape, device)
    timed("rollout", lambda d: torch.sum(simulate_trajectory(model, x0s + d, us0, g_z)[1]), dx0)
    timed("linearize", lambda d: sum(torch.sum(v) for v in linearize_dynamics(
        model, (xss + d)[:, :-1], us0)), dxs)
    timed("quadratize", lambda d: sum(torch.sum(v) for v in quadratize_cost(
        model, xss + d, us0, g_z, gauss_newton=True)), dxs)

    def sub(d, use_fused):
        pol = solver._subproblem(xss + d, us0, g_z, reg, use_fused)
        return torch.sum(pol.k) + torch.sum(pol.K)

    def sub_ls(d, use_fused):
        xs = xss + d
        pol = solver._subproblem(xs, us0, g_z, reg, use_fused)
        alphas = solver.alphas(device)
        if use_fused:
            _, _, costs = fused_linesearch(
                model, alphas, xs[:, 0].contiguous(), us0, pol.k.contiguous(),
                pol.K.contiguous(), xs.contiguous(), g_z, with_terminal=True,
                return_states=True)
        else:
            _, _, costs = solver._try_step(alphas, pol, xs, us0, g_z)
        return torch.sum(costs)

    # solve_batch's route: the kernels on the card, their plain versions on the CPU
    timed("subproblem(lin+quad+riccati)", lambda d: sub(d, True), dxs)
    timed("subproblem+linesearch", lambda d: sub_ls(d, True), dxs)
    timed("subproblem_plain", lambda d: sub(d, False), dxs)
    timed("subproblem+linesearch_plain", lambda d: sub_ls(d, False), dxs)

    gen = torch.Generator(device=device).manual_seed(args.seed)
    for mi, b in ([(6, B)] if q else [(6, 128), (6, 1024), (4, 1024), (2, 1024)]):
        sv = SQP(model=model, T=T, max_iter=mi)
        x0b = start.expand(b, -1).contiguous()

        def whole(d, sv=sv, b=b, x0b=x0b):
            state = sv.init_state_batch(b, gen, device)
            _, u0, _ = sv.solve_batch(state, (x0b + d).contiguous(), g_z)
            return torch.sum(u0)

        timed(f"solve_x{mi}iter_B{b}", whole, perturbations(x0b.shape, device, scale=1e-3))

    return {"config": f"acrobot SQP T={T} stage-batch B={B}", "device": device_record(device),
            "stage_ms": stages}


def main(argv=None) -> dict:
    args = measure_parser(__doc__).parse_args(argv)
    out = run(args)
    write_measure(args, "profile_sqp", out)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
