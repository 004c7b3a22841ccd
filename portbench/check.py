"""What decides ``correct``: a sample of the window's episodes, drawn from
the seed, held against the plain reference computed again from the same
inputs.

During the window a reservoir keeps the outputs of ``sample_batches``
batches, each batch equally likely whatever the window's length. Once the
window has closed, ``sample_scenarios`` scenarios of each kept batch are
drawn and the reference runs their closed-loop episodes from the same
inputs. Three numbers are compared:

- ``first_action_gap``: the largest |action − reference action| at the
  first MPC step, which the solver takes from the inputs alone (a zero plan
  and the start state);
- ``departed_pct``: the share of the sampled episodes, in %, whose action
  departs from the reference's by more than ``DEPART`` at some step;
- ``plant_gap``: the largest relative residual of the plant over every step,
  |x_{s+1} − f(x_s, u_s)| and |c_s − cost(x_s, u_s)|, each over max(1, |f|) or
  max(1, |cost|),
  taken from the program's own recorded states and actions.

Why not the largest gap over the whole loop: the loop is chaotic at these
widths (with λ = 1 MPPI's weights follow cost differences of tens), so a
sound change of the order in which a sum is rounded makes a few episodes in
a hundred reach actions at opposite bounds within ten steps, while the
median episode stays the same to the bit (``PERF.md`` gives the readings).
A gap that is not a number counts as infinite, an episode with one as
departed. The limits are the cell's (``checks/<workload>.json``), set from
the program's sound runs and the control's readings.
"""

from __future__ import annotations

import importlib

import numpy as np
import torch

GAPS = ("first_action_gap", "departed_pct", "plant_gap")
DEPART = 1e-3  # an action this far from the reference's has departed


class Reservoir:
    """Keeps k of the items offered, each equally likely, from ``rng``."""

    def __init__(self, k: int, rng: np.random.Generator):
        self.k, self.rng, self.items, self.seen = k, rng, [], 0

    def offer(self, item) -> None:
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.k:
                self.items[j] = item
        self.seen += 1


def _finite_max(d) -> float:
    if d.numel() == 0:
        return 0.0
    v = float(d.max())  # NaN propagates through max
    return v if np.isfinite(v) else float("inf")


def _residual(got, want) -> torch.Tensor:
    return (got - want).abs() / torch.clamp(want.abs(), min=1.0)


def gaps(prog, ref, plant) -> dict:
    """The three numbers for the program's (actions (n, N), states
    (n, N + 1, S), costs (n, N)) against the reference's ``Episodes``, with
    the reference's plant module for the one-step residual."""
    actions, states, costs = (t.to(torch.float32) for t in prog)
    da = (actions - ref.actions).abs()
    departed = (torch.isnan(da) | (da > DEPART)).any(dim=1)
    u = actions[..., None]
    x_next = plant.dynamics(states[:, :-1], u)
    cost = plant.stage_cost(states[:, :-1], u)
    return {"first_action_gap": _finite_max(da[:, :1]),
            "departed_pct": 100.0 * float(departed.float().mean()) if departed.numel() else 0.0,
            "plant_gap": max(_finite_max(_residual(states[:, 1:], x_next)),
                             _finite_max(_residual(costs, cost)))}


def program_outputs(result, idx) -> tuple:
    """The program's (actions, true states, costs) of scenarios ``idx``."""
    i = torch.as_tensor(idx, dtype=torch.int64, device=result.costs.device)
    return result.actions[i, :, 0], result.true_states[i], result.costs[i]


def reference_for(config: dict):
    """(plant module, solver module) of the reference a configuration names."""
    plant = importlib.import_module(f"portbench.reference.{config['env']}")
    solver = importlib.import_module(f"portbench.reference.{config['solver'].lower()}")
    return plant, solver


def sample(seed: int, batch: int, B: int, n: int) -> np.ndarray:
    """The sorted scenarios of a kept batch that the check compares."""
    rng = np.random.default_rng(np.random.SeedSequence([seed & (2**64 - 1), int(seed < 0), 8,
                                                        batch]))
    return np.sort(rng.choice(B, size=min(n, B), replace=False))


def judge(readings: dict, limits: dict) -> bool:
    return all(readings[k] <= limits[k] for k in GAPS)
