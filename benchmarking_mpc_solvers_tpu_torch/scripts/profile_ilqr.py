"""Stage breakdown of the batched iLQR iteration at configuration 3
(cart-pole swing-up, T=100, B=1,024).

Counterpart of ``scripts/profile_ilqr.py``, with its stage keys: the
nominal rollout, the derivatives (every output summed, so that no part of
the stage is cut), the backward pass plain (``ILQR.backward_pass``) and
through kernel 5 (``riccati_backward_batch``), the 10-α forward passes
plain (``ILQR.forward_pass``) and through kernel 6 (``fused_linesearch``),
and the whole solve (``solve_batch``, max_iter 5: kernels 5 and 6 on the
card). Each stage is a chained paired difference
(``utils.device_step_latency``) over 8 inputs perturbed by 1e-6·N(0, 1).
Writes ``<results-dir>/measure/profile_ilqr.json``.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ..device import resolve_device
from ..envs import CartPoleSwingUpEnv
from ..ops.fused_linesearch import fused_linesearch
from ..ops.riccati_backward import riccati_backward_batch
from ..ops.rollout import simulate_trajectory
from ..solvers import ILQR
from ._common import (
    chain_options, device_record, measure_parser, perturbations, stage_timer, write_measure)


def run(args) -> dict:
    device = resolve_device(args.device)
    q = args.quick
    env = CartPoleSwingUpEnv
    model = env.model
    T, B = (5, 4) if q else (100, 1024)
    samples = args.samples or (2 if q else 10)
    solver = ILQR(model=model, T=T, max_iter=5, reference_accept=False)
    g_z = torch.zeros((T, model.goal_size), device=device)
    S, A = model.state_size, model.action_size

    rng = np.random.default_rng(args.seed)
    x0s = (env.start_state(device).expand(B, -1)
           + torch.from_numpy((1e-2 * rng.standard_normal((B, S))).astype(np.float32))
           .to(device)).contiguous()
    us0 = torch.from_numpy((0.1 * rng.standard_normal((B, T, A))).astype(np.float32)).to(device)
    xss, _ = simulate_trajectory(model, x0s, us0, g_z)
    derivs = solver.derivatives(xss, us0, g_z)
    mu = torch.ones((B,), device=device)

    stages = {}
    timed = stage_timer(stages, device, samples, chain_options(args))
    dx0, dxs = perturbations(x0s.shape, device), perturbations(xss.shape, device)

    timed("rollout", lambda d: torch.sum(simulate_trajectory(model, x0s + d, us0, g_z)[1]), dx0)
    timed("derivatives", lambda d: sum(torch.sum(v) for v in solver.derivatives(
        xss + d, us0, g_z)), dxs)

    dlx = perturbations(derivs.l_x.shape, device)

    def bp_plain(d):
        ks, Ks, _ok = solver.backward_pass(derivs._replace(l_x=derivs.l_x + d), mu)
        return torch.sum(ks) + torch.sum(Ks)

    def bp_kernel(d):
        ks, Ks, _ok = riccati_backward_batch(
            (derivs.l_x + d).contiguous(), *(t.contiguous() for t in derivs[1:]), mu)
        return torch.sum(ks) + torch.sum(Ks)

    timed("backward_scan", bp_plain, dlx)
    timed("backward_pallas", bp_kernel, dlx)

    ks0 = torch.zeros((B, T, A), device=device)
    Ks0 = torch.zeros((B, T, A, S), device=device)
    alphas = solver.alphas(device)
    timed("forward_x10_scan", lambda d: torch.sum(solver.forward_pass(
        alphas, ks0, Ks0, xss + d, us0, g_z)[2]), dxs)
    timed("forward_x10_fused", lambda d: torch.sum(fused_linesearch(
        model, alphas, x0s, us0, ks0, Ks0, (xss + d).contiguous(), g_z,
        with_terminal=True)[1]), dxs)

    gen = torch.Generator(device=device).manual_seed(args.seed)
    dx0_solve = perturbations(x0s.shape, device, scale=1e-3)

    def whole(d):
        state = solver.init_state_batch(B, gen, device)
        _, u0, _ = solver.solve_batch(state, (x0s + d).contiguous(), g_z)
        return torch.sum(u0)

    timed("solve_x5iter", whole, dx0_solve)
    return {"config": f"cartpole iLQR T={T} B={B}", "device": device_record(device),
            "stage_ms": stages}


def main(argv=None) -> dict:
    args = measure_parser(__doc__).parse_args(argv)
    out = run(args)
    write_measure(args, "profile_ilqr", out)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
