"""Headline benchmark: batched cart-pole swing-up MPC solves/s on the card at horizon 50.

Counterpart of the root ``bench.py``. Prints ONE JSON line:
    {"metric": ..., "value": N, "unit": ..., "vs_baseline": N}

Metric definition (BASELINE.json): full MPC solve steps per second per card:
each solve is one MPPI step (K rollout evaluations of horizon T=50 and the
softmax update) plus the plant step, in a batched closed-loop simulation on
the single-kernel episode tier. The MPPI update runs as ONE kernel launch
per MPC step (in-kernel noise, rollouts, softmax and plan update,
``ops/fused_mppi.py``, ``csrc/fused_mppi.cu``): no (B·K)-sized arrays in
device memory.

Timing method: ``utils.slope_timer`` times chains of 1 and ``INNER_REPS``
episode batches, ``OUTER_REPS`` times each after a warm-up, each chain
summing the batches' costs into one scalar that is fetched at its end. A
chain pays once for the host's launches before the card starts, the
synchronise and that fetch; the slope between the two lengths cancels them
and leaves the device-paced time of one batch. Each batch draws its own
per-call seeds from the timer's generator.

vs_baseline: derived from BASELINE.md for the matching config (CartpoleSwingup,
MPPI, T=50). The reference's table row aggregates Σ passed_time = 1.5e3 s
(`ResultPlots/time_comparison/CartpoleSwingupEnvironment_T_table.tex:21`) over
every matching run in its four MongoDB collections
(`scripts/table_generation.py:22`): the mppi_samples sweep (5 K-values x 5
repetitions, `scripts/sample_test.py:28,36-47`) plus the temperature_exp sweep
(6 lambda-values x 5 repetitions, `scripts/mppi_temperature.py:23-29`) = 55
runs x 100 timed solves each (`ExperimentCore/Experiment.py:79-99`; warm-start
iterations are untimed) = 5,500 solves. Reference rate = 5500 / 1.5e3 s =
3.7 solves/s on its 12-core host; vs_baseline = ours / 3.7.

``--device`` defaults to ``cuda`` (raises without a card); ``--device cpu``
runs the plain version, a smoke run and no measurement. Non-finite episode
costs raise.
"""

from __future__ import annotations

import argparse
import json
import math

from ..device import resolve_device
from ..envs import CartPoleSwingUpEnv
from ..experiment import EpisodeConfig, run_episodes_fused
from ..solvers import MPPI
from ..utils import slope_timer

REFERENCE_SOLVES_PER_SEC = 5500.0 / 1.5e3  # = 3.7, see module docstring
HORIZON = 50
K_SAMPLES = 32
BATCH = 8192
N_STEPS = 20
INNER_REPS = 9
OUTER_REPS = 3


def result_line(per_batch_s: float) -> dict:
    """The benchmark's line for ``per_batch_s`` seconds a batch of
    ``BATCH`` episodes of ``N_STEPS`` steps."""
    solves_per_sec = BATCH * N_STEPS / per_batch_s
    return {
        "metric": f"cartpole MPC solves/s/chip (MPPI K={K_SAMPLES}, T={HORIZON}, "
                  f"batch={BATCH}, fused cuda)",
        "value": round(float(solves_per_sec), 1),
        "unit": "solves/s",
        "vs_baseline": round(float(solves_per_sec / REFERENCE_SOLVES_PER_SEC), 1),
    }


def main(argv=None, timer=slope_timer) -> dict:
    """Times the benchmark's episodes with ``timer`` (``utils.slope_timer``'s
    signature), prints the line and returns it."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without a card) or cpu")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    env = CartPoleSwingUpEnv
    solver = MPPI(model=env.model, T=HORIZON, K=K_SAMPLES, std=1.0, lam=1.0)
    cfg = EpisodeConfig(n_steps=N_STEPS, warmstart=0, record_plans=False)
    x0s = env.start_state(device).expand(BATCH, -1).contiguous()
    checksums = []

    def one_batch(gen):
        total = run_episodes_fused(env, solver, cfg, x0s, generator=gen, device=device).costs.sum()
        checksums.append(total)
        return total

    per_batch = timer(one_batch, inner_reps=INNER_REPS, outer_reps=OUTER_REPS, device=device)
    if not all(math.isfinite(float(c)) for c in checksums):
        raise RuntimeError("non-finite episode costs")
    rec = result_line(per_batch)
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
