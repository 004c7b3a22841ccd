"""The benchmark suite on the card: one JSON line per configuration.

Counterpart of ``scripts/bench_suite.py``, with its six configurations at
its widths, full and ``--quick`` (``configurations``), and its line keys:

 1. pendulum, QP-MPC T=20, condensed ADMM (100 iterations), B=512, 50 steps;
 2. cart-pole stabilisation, QP-MPC T=50 Riccati-ADMM (60 iterations) with
    box inputs, B=256 from (0.3, 0, 0.4, 0), 40 steps;
 3. cart-pole swing-up, iLQR T=100 (5 iterations), B=1,024, warm start 10,
    20 steps;
 4. acrobot, SQP T=100 (4 iterations), B=1,024 from (0.1, 0, 0.2, 0),
    20 steps;
 5. all six families on cart-pole, T=50, 10 steps, B = max(1,280 a card,
    10,240), the batch sharded over the cards present (``parallel.make_mesh``);
 6. pendulum, I2C T=25 (10 iterations), B=256, 50 steps.

Paths. Configurations 1, 2, 3, 4 and 6 run ``run_episodes_fused``: the
batched solve with its stages on the kernels (1: kernel 7's ADMM; 2: the
Riccati-ADMM at the goal, plain PyTorch in both packages; 3: kernels 5 and
6; 4: kernels 4, 5 and 6; 6: kernels 8a and 8b), where the JAX script runs
``jax.vmap`` of the scalar episode, whose batching rules reach the same
kernels. In configuration 5 each family takes the path the JAX script's
rule picks (``JAX_PATHS``): MPPI and CEM the single-kernel tier
(``sharded_episodes_kernel``: kernels 1 and 3), QP-MPC its batched
``solve_batch`` tier, iLQR, SQP and I2C the JAX script's "vmapped_scalar",
here their batched ``solve_batch(use_fused=True)`` (``sharded_episodes``
with ``use_fused``: kernels 5 and 6, 4 to 6, 8a and 8b). Its line's
``episode_path_by_solver`` names the JAX path and
``episode_route_by_solver`` the port's.

Each line reports:
- ``solves_per_sec``: B·n_steps over the seconds of one batch of episodes,
  slope-timed (``utils.slope_timer``: chains of 1 and ``inner`` batches,
  ``outer`` times each). A chain pays once for what does not scale with its
  length: the host's launches before the card starts, the synchronise and
  the fetch of the summed costs at its end. The slope cancels that.
  Every timed batch starts from x0 + 1e-3·N(0, 1), drawn from the timer's
  generator, as the JAX script's timed runs do.
- ``p50/p90_step_latency_ms``: one batched MPC step (the solve of all B
  scenarios and the plant step) from ``utils.device_step_latency``: chains
  of two lengths timed in pairs, the difference cancelling each chain's
  constant. A step is host-issued PyTorch, so a step whose host work
  outlasts its device work reads its host time.
- ``amortized_step_ms``: the slope-timed batch of episodes over n_steps.
- ``episode_cost``: the median over scenarios of an untimed batch's summed
  costs, from the start states without jitter; ``constraint_violation``:
  the largest box violation of a commanded action.

A ``solves_per_sec`` of null is a slope below 1 µs (not resolved), as in
the JAX script. Lines go to standard output and, one by one as each
configuration ends, to ``<results-dir>/measure/bench_suite.jsonl``.

``--device`` (default ``cuda``; raises without a card) is where everything
runs; ``--device cpu`` runs the plain versions, a smoke run and no
measurement. Depth cuts for a short run on the card, which change no
width: ``--steps N`` caps every configuration's n_steps and warm start,
``--inner``/``--outer`` the slope timer's chains, ``--samples`` and
``--min-chains`` the latency's samples and chains; ``--only`` picks
configurations by number.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys
from typing import Callable, List, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..envs import AcrobotEnv, CartPoleSwingUpEnv, PendulumEnv
from ..envs.env import Env, env_step
from ..experiment import EpisodeConfig, run_episodes_fused
from ..parallel import make_mesh, sharded_episodes, sharded_episodes_kernel
from ..solvers import CEM, I2C, ILQR, MPPI, QPMPC, SQP
from ..utils import device_step_latency, slope_timer
from ._common import chain_options, measure_parser

# configuration 5: the JAX script's path of each family without a kernel
# tier (scripts/bench_suite.py:289-294: a dedicated solve_batch, else the
# vmapped scalar episode)
JAX_PATHS = {"QPMPC": "solve_batch", "ILQR": "vmapped_scalar", "SQP": "vmapped_scalar",
             "I2C": "vmapped_scalar"}
# the port's route of each JAX path, and the kernels it launches
ROUTES = {
    "single_kernel": "sharded_episodes_kernel (kernel 1 MPPI, kernel 3 CEM)",
    "QPMPC": "sharded_episodes(use_fused=True): Riccati-ADMM solve_batch, plain PyTorch",
    "ILQR": "sharded_episodes(use_fused=True): solve_batch(use_fused=True), kernels 5 and 6",
    "SQP": "sharded_episodes(use_fused=True): solve_batch(use_fused=True), kernels 4, 5 and 6",
    "I2C": "sharded_episodes(use_fused=True): solve_batch(use_fused=True), kernels 8a and 8b",
}


@dataclasses.dataclass
class Config:
    """One configuration: its line's name, the environment, the solver rows
    (one, except configuration 5's six), the episode, the batch and start
    state (None: the environment's), the slope timer's chains and the
    latency's sample count ``latency_n`` (samples = max(4, n // 2)). The
    latency's solver is the first row's, or ``latency_solver``."""
    key: int
    name: str
    env: Env
    rows: list
    cfg: EpisodeConfig
    B: int
    x0: Optional[tuple]
    inner: int
    outer: int
    latency_n: int
    latency_solver: object = None


def configurations(quick: bool, n_dev: int = 1) -> List[Config]:
    """The JAX script's six configurations (scripts/bench_suite.py:164-347),
    full or ``--quick``, for ``n_dev`` cards."""
    q = quick
    cart = CartPoleSwingUpEnv.model
    T5 = 5 if q else 50
    B5 = 2 * n_dev if q else max(n_dev * 1280, 10240)
    cfg5 = EpisodeConfig(n_steps=2 if q else 10, record_plans=False)
    return [
        Config(1, "pendulum linear MPC T=20 condensed ADMM", PendulumEnv,
               [("QPMPC", QPMPC(model=PendulumEnv.model, T=10 if q else 20, method="admm",
                                iters=20 if q else 100))],
               EpisodeConfig(n_steps=5 if q else 50, record_plans=False),
               8 if q else 512, None, 3 if q else 81, 1 if q else 3, 5 if q else 30),
        Config(2, "cartpole stabilization QP MPC T=50 box-constrained", CartPoleSwingUpEnv,
               [("QPMPC", QPMPC(
                   model=cart, T=10 if q else 50, iters=20 if q else 60,
                   goal_x=(0.0, 0.0, 0.0, 0.0),
                   Q=((0.5, 0, 0, 0), (0, 0.1, 0, 0), (0, 0, 5.0, 0), (0, 0, 0, 0.5)),
                   R=((0.1,),)))],
               EpisodeConfig(n_steps=5 if q else 40, record_plans=False),
               8 if q else 256, (0.3, 0.0, 0.4, 0.0), 3 if q else 7, 1 if q else 2,
               5 if q else 30),
        Config(3, "cartpole swing-up iLQR T=100 batched 1k states", CartPoleSwingUpEnv,
               [("ILQR", ILQR(model=cart, T=10 if q else 100, max_iter=1 if q else 5,
                              threshold=1e-3, reference_accept=False))],
               EpisodeConfig(n_steps=3 if q else 20, warmstart=1 if q else 10,
                             record_plans=False),
               4 if q else 1024, None, 3 if q else 9, 1 if q else 3, 5 if q else 30),
        Config(4, "acrobot NMPC SQP T=100 batched 1k states", AcrobotEnv,
               [("SQP", SQP(model=AcrobotEnv.model, T=10 if q else 100,
                            max_iter=2 if q else 4))],
               EpisodeConfig(n_steps=3 if q else 20, record_plans=False),
               4 if q else 1024, (0.1, 0.0, 0.2, 0.0), 3 if q else 5, 1 if q else 3,
               5 if q else 30),
        Config(5, f"multi-solver sweep (6 families) x {B5} scenarios sharded over "
                  f"{n_dev} device(s)", CartPoleSwingUpEnv,
               [("MPPI", MPPI(model=cart, T=T5, K=8 if q else 64)),
                ("CEM", CEM(model=cart, T=T5, K=8 if q else 64, n_elite=2 if q else 8,
                            max_iter=1 if q else 3)),
                ("QPMPC", QPMPC(model=cart, T=T5, iters=10 if q else 50)),
                ("ILQR", ILQR(model=cart, T=T5, max_iter=1 if q else 3,
                              reference_accept=False)),
                ("SQP", SQP(model=cart, T=T5, max_iter=1 if q else 3)),
                ("I2C", I2C(model=cart, T=T5, max_iter=1 if q else 3))],
               cfg5, B5, None, 2 if q else 5, 1, 5 if q else 20,
               latency_solver=MPPI(model=cart, T=T5, K=8 if q else 64)),
        Config(6, "pendulum swing-up I2C T=25", PendulumEnv,
               [("I2C", I2C(model=PendulumEnv.model, T=10 if q else 25,
                            max_iter=2 if q else 10))],
               EpisodeConfig(n_steps=5 if q else 50, record_plans=False),
               8 if q else 256, None, 3 if q else 9, 1 if q else 3, 5 if q else 30),
    ]


def jax_path(label: str, solver) -> str:
    """The path the JAX script's rule gives a configuration-5 family."""
    if getattr(solver, "kernel_ok", None) and solver.kernel_ok():
        return "single_kernel"
    return JAX_PATHS[label]


def violation(actions, lo: float, hi: float) -> float:
    a = np.asarray(actions)
    return float(np.maximum(np.maximum(a - hi, lo - a), 0.0).max())


def line(name, solves_per_sec, lat, cost, viol, extra=None) -> dict:
    """The JAX script's line (its ``report``), with its rounding."""
    p50, p90, amort = lat
    return {
        "config": name,
        "solves_per_sec": None if solves_per_sec is None else round(solves_per_sec, 1),
        "p50_step_latency_ms": None if p50 is None else round(p50, 4),
        "p90_step_latency_ms": None if p90 is None else round(p90, 4),
        "amortized_step_ms": None if amort is None else round(amort, 4),
        "episode_cost": round(cost, 2),
        "constraint_violation": viol,
        **(extra or {}),
    }


def timed_per_call(fn, inner: int, outer: int, device) -> Optional[float]:
    """Slope-timed seconds per call, None below 1 µs (unresolved)."""
    per_call = slope_timer(fn, inner_reps=inner, outer_reps=outer, device=device)
    return per_call if per_call > 1e-6 else None


def _generators(mesh, gen) -> list:
    """One generator per shard, seeded from ``gen``."""
    seeds = torch.randint(0, 2**62, (mesh.size,), generator=gen, device=gen.device).tolist()
    return [torch.Generator(device=d).manual_seed(s)
            for s, d in zip(seeds, mesh.axis_devices("batch"))]


def episode_runner(conf: Config, label: str, solver, device, mesh=None) -> Callable:
    """``run(x0s, gen) -> EpisodeResult`` on the configuration's path."""
    env, cfg = conf.env, conf.cfg
    if mesh is None:
        return lambda x0s, gen: run_episodes_fused(env, solver, cfg, x0s, generator=gen,
                                                   device=device)
    if jax_path(label, solver) == "single_kernel":
        fn = sharded_episodes_kernel(env, solver, cfg, mesh)
    else:
        fn = sharded_episodes(env, solver, cfg, mesh, use_fused=True)
    return lambda x0s, gen: fn(x0s, generators=_generators(mesh, gen))


def step_latency_dist(conf: Config, solver, x0s, samples: int, chains: dict, device):
    """(p50_ms, p90_ms) of one batched MPC step: the solve of all B
    scenarios on the path's batched tier (the single-kernel step where the
    solver has one, else ``solve_batch(use_fused=True)``), the clip and the
    plant step."""
    env, cfg, model = conf.env, conf.cfg, solver.model
    B = x0s.shape[0]
    g_z = torch.zeros((solver.T, model.goal_size), dtype=torch.float32, device=device)
    gen = torch.Generator(device=device).manual_seed(7)
    if getattr(solver, "kernel_ok", None) and solver.kernel_ok():
        lo, hi = float(model.bounds_low[0]), float(model.bounds_high[0])
        carry = (torch.zeros((solver.T, B), dtype=torch.float32, device=device), x0s)

        def one(c, seed):
            plan, obs = c
            plan, u0s = solver.solve_batch_tm(plan, obs.T.contiguous(), g_z, seed)
            plan = torch.clamp(plan, lo, hi)
            es = env_step(env, obs, torch.clamp(u0s, lo, hi)[:, None], cfg.noise, gen)
            return (plan, es.observation), es.observation.sum()
    else:
        carry = (solver.init_state_batch(B, gen, device), x0s)

        def one(c, seed):
            st, obs = c
            st, u0s, _ = solver.solve_batch(st, obs, g_z, use_fused=True)
            st = st._replace(planned_us=model.clip_action(st.planned_us))
            es = env_step(env, obs, model.clip_action(u0s), cfg.noise, gen)
            return (st, es.observation), es.observation.sum()
    seeds = [8 + i for i in range(8)]
    return device_step_latency(one, carry, seeds, samples=samples, device=device, **chains)


def _cut(conf: Config, args) -> Config:
    """The configuration under the depth options: fewer steps, shorter
    chains, fewer samples; no width changes."""
    cfg = conf.cfg
    if args.steps is not None:
        cfg = dataclasses.replace(cfg, n_steps=min(cfg.n_steps, args.steps),
                                  warmstart=min(cfg.warmstart, args.steps))
    return dataclasses.replace(conf, cfg=cfg, inner=args.inner or conf.inner,
                               outer=args.outer or conf.outer)


def run_config(conf: Config, args, device, n_dev: int) -> dict:
    """One configuration's line."""
    conf = _cut(conf, args)
    env, cfg, B = conf.env, conf.cfg, conf.B
    x0 = env.start_state(device) if conf.x0 is None else torch.tensor(
        conf.x0, dtype=torch.float32, device=device)
    x0s = x0.expand(B, -1).contiguous()
    samples = args.samples or max(4, conf.latency_n // 2)
    chains = chain_options(args)
    lo, hi = float(env.model.bounds_low[0]), float(env.model.bounds_high[0])
    mesh = make_mesh(n_dev, device_type=device.type) if conf.key == 5 else None
    rows, sps, lat5, paths, routes = [], {}, [], {}, {}
    res = per = None
    for label, solver in conf.rows:
        run = episode_runner(conf, label, solver, device, mesh)
        res = run(x0s, torch.Generator(device=device).manual_seed(0))
        cost = float(np.median(res.costs.sum(dim=-1).cpu().numpy()))
        rows.append((label, cost))

        def scalar(gen, run=run):
            x = x0s + 1e-3 * torch.randn(x0s.shape, generator=gen, device=device)
            return run(x, gen).costs.sum()

        per = timed_per_call(scalar, conf.inner, conf.outer, device)
        if mesh is not None:
            path = jax_path(label, solver)
            paths[label] = path
            routes[label] = ROUTES["single_kernel" if path == "single_kernel" else label]
            sps[label] = round(B * cfg.n_steps / per, 1) if per else None
            if per:
                lat5.append(per / cfg.n_steps * 1e3)
        print(f"[bench_suite {conf.key}] {label}: median cost {cost:.4f}, "
              f"{'unresolved' if per is None else f'{per:.6f} s a batch'}",
              file=sys.stderr, flush=True)
    p50, p90 = step_latency_dist(conf, conf.latency_solver or conf.rows[0][1], x0s, samples,
                                 chains, device)
    if mesh is None:
        extra = None
        if conf.key == 2:
            final = res.true_states[:, -1, 2].abs().max().item()
            extra = {"max_final_pole_angle_rad": round(final, 4)}
        return line(conf.name, B * cfg.n_steps / per if per else None,
                    (p50, p90, per / cfg.n_steps * 1e3 if per else None), rows[0][1],
                    violation(res.true_actions.cpu().numpy(), lo, hi), extra)
    resolved = [v for v in sps.values() if v is not None]
    return line(conf.name, sum(resolved) / len(resolved) if resolved else None,
                (p50, p90, float(np.median(lat5)) if lat5 else None), rows[0][1], 0.0,
                {"median_costs": {n: round(c, 1) for n, c in rows},
                 "solves_per_sec_by_solver": sps, "episode_path_by_solver": paths,
                 "episode_route_by_solver": routes})


def parser() -> argparse.ArgumentParser:
    p = measure_parser(__doc__)
    p.add_argument("--steps", type=int, default=None,
                   help="cap every configuration's n_steps and warm start (a depth cut)")
    p.add_argument("--inner", type=int, default=None,
                   help="the slope timer's long chain (default: the configuration's)")
    p.add_argument("--outer", type=int, default=None,
                   help="the slope timer's repetitions (default: the configuration's)")
    p.add_argument("--only", type=int, nargs="+", default=None,
                   help="configurations to run, by number (default: all six)")
    return p


def main(argv=None, before: Optional[Callable] = None, after: Optional[Callable] = None):
    """Runs the configurations and prints their lines; returns them.
    ``before(conf)`` and ``after(conf, line)`` are called around each."""
    args = parser().parse_args(argv)
    device = resolve_device(args.device)
    n_dev = torch.cuda.device_count() if device.type == "cuda" else 1
    out = pathlib.Path(args.results_dir) / "measure" / "bench_suite.jsonl"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text("")
    lines = []
    for conf in configurations(args.quick, n_dev):
        if args.only and conf.key not in args.only:
            continue
        if before:
            before(conf)
        rec = run_config(conf, args, device, n_dev)
        if after:
            after(conf, rec)
        print(json.dumps(rec), flush=True)
        with out.open("a") as f:
            f.write(json.dumps(rec) + "\n")
        lines.append(rec)
    return lines


if __name__ == "__main__":
    main()
