"""Weak scaling of MPPI over a device mesh: solves/s against device count.

Counterpart of ``scripts/scaling_bench.py``, with its configuration (cart-pole,
T=50, K=32, 512 scenarios per device, 10 MPC steps) and record keys. For
each n of 1, 2, 4, 8 up to the devices present (``parallel.make_mesh(n)``;
``--device cpu`` repeats the CPU device, ``--devices`` sets the count), the
scenario batch of n·512 runs through ``sharded_episodes_kernel`` (kernel 1 on
each card; no communication between devices), a few episodes after a
warm-up, timed on the host clock; and the same batch on a one-device mesh,
whose ratio is the partition overhead. Prints one JSON line per n and writes
them to ``<results-dir>/measure/scaling_bench.json``.

For several hosts, start the process group with
``benchmarking_mpc_solvers_tpu_torch.parallel.distributed_init`` on each host
first; the per-host invocation is otherwise the same.
"""

from __future__ import annotations

import json
import os

import torch

from ..device import resolve_device
from ..envs import CartPoleSwingUpEnv
from ..experiment import EpisodeConfig
from ..parallel import make_mesh, sharded_episodes_kernel
from ..solvers import MPPI
from ..utils import Timer
from ._common import device_record, std_parser, write_measure


def _generators(mesh, seed):
    return [torch.Generator(device=d).manual_seed(seed + i)
            for i, d in enumerate(mesh.axis_devices("batch"))]


def _sync(device):
    if device.type == "cuda":
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)


def run(args) -> dict:
    device = resolve_device(args.device)
    q = args.quick
    env = CartPoleSwingUpEnv
    solver = MPPI(model=env.model, T=10 if q else 50, K=8 if q else 32)
    cfg = EpisodeConfig(n_steps=3 if q else 10, record_plans=False)
    per_dev_B = 8 if q else 512
    reps = 2 if q else 4
    n_all = args.devices or (torch.cuda.device_count() if device.type == "cuda" else 1)
    counts = [n for n in (1, 2, 4, 8) if n <= n_all]
    shared_host = device.type == "cpu"
    lines, base = [], None
    one = make_mesh(1, device_type=device.type)
    for n in counts:
        mesh = make_mesh(n, device_type=device.type)
        B = per_dev_B * n  # weak scaling: constant work per device
        x0s = env.start_state(device).expand(B, -1).contiguous()
        fn = sharded_episodes_kernel(env, solver, cfg, mesh)
        fn1 = sharded_episodes_kernel(env, solver, cfg, one)

        def episodes(f, m):
            for i in range(reps):
                f(x0s, generators=_generators(m, i + 1))
            _sync(device)

        f_warm = fn(x0s, generators=_generators(mesh, 0))  # warm-up
        _sync(device)
        with Timer() as t:
            episodes(fn, mesh)
        solves = B * cfg.n_steps * reps / t.elapsed
        base = solves if base is None else base
        eff = solves / (base * n)
        # partition overhead: the same work unsharded, on one device
        fn1(x0s, generators=_generators(one, 0))
        _sync(device)
        with Timer() as t1:
            episodes(fn1, one)
        lines.append({
            "devices": n, "batch": B, "solves_per_sec": round(solves, 1),
            "weak_scaling_efficiency": round(eff, 3),
            "partition_overhead_vs_1dev_same_work": round(t.elapsed / t1.elapsed, 3),
            "note": (f"the CPU device {n} times: the shards share {os.cpu_count()} cores"
                     if shared_host else "real devices"),
            "finite": bool(torch.isfinite(f_warm.costs).all())})
        print(json.dumps(lines[-1]), flush=True)
    return {"device": device_record(device), "lines": lines}


def main(argv=None) -> dict:
    p = std_parser(__doc__)
    p.add_argument("--devices", type=int, default=None,
                   help="the largest mesh (default: every card; 1 on the CPU)")
    args = p.parse_args(argv)
    out = run(args)
    write_measure(args, "scaling_bench", out)
    return out


if __name__ == "__main__":
    main()
