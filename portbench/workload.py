"""The one general generator: a cell's configuration and traffic files turned
into the program's objects and into seeded batches of closed-loop episodes.

A configuration names the plant (``env``), the solver family and its
arguments and the episode length; a traffic mix names the batch of
scenarios, the start states' jitter and the noise. Everything a batch
takes is made from (``--seed``, batch index): the start states on the card
(the plant's default start plus ``x0_jitter``·N(0, 1)), the per-call int32
noise seeds, and the seed of the plant's CUDA generator. The program gets
only these inputs and runs them through its normal entry point,
``experiment.episode.run_episodes_fused``.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
WINDOW, WARMUP = 1, 0  # the two streams of batch inputs a seed gives


def find(kind: str, name: str, root: Path = HERE) -> Path:
    """The file of a configuration, traffic mix, check or metric by name."""
    suffix = ".py" if kind == "metrics" else ".json"
    path = root / kind / f"{name}{suffix}"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file for {name!r}: {path}")
    return path


def load_json(kind: str, name: str, root: Path = HERE) -> dict:
    return json.loads(find(kind, name, root).read_text())


class BatchInputs(NamedTuple):
    x0s: torch.Tensor  # (B, S) float32 start states on the device
    call_seeds: list  # one int32 seed per solver call
    plant_seed: int  # seed of the plant's (and the two-stage tier's) generator


def _entropy(seed: int, stream: int, i: int) -> list:
    """SeedSequence words of (seed, stream, batch): any whole seed, any sign."""
    return [seed & (2**64 - 1), int(seed < 0), stream, i]


class Workload:
    """A cell's program objects and its seeded batches on ``device``."""

    def __init__(self, config: dict, traffic: dict, device="cuda"):
        from benchmarking_mpc_solvers_tpu_torch import solvers
        from benchmarking_mpc_solvers_tpu_torch.envs.env import REGISTRY, NoiseConfig
        from benchmarking_mpc_solvers_tpu_torch.experiment.episode import (
            EpisodeConfig, run_episodes_fused)

        self.config, self.traffic = config, traffic
        self.device = torch.device(device)
        self.env = REGISTRY[config["env"]]
        args = dict(config["solver_args"])
        if traffic.get("model_noise_std", 0.0):
            args["model_noise_std"] = traffic["model_noise_std"]
        self.solver = getattr(solvers, config["solver"])(model=self.env.model, **args)
        self.episode = EpisodeConfig(
            n_steps=config["n_steps"], warmstart=0, record_plans=False,
            noise=NoiseConfig(actuation_std=traffic.get("actuation_std", 0.0),
                              sensor_std=traffic.get("sensor_std", 0.0)))
        self._run = run_episodes_fused
        self.B = traffic["batch"]
        self.steps = config["n_steps"]
        self.start = torch.tensor(self.env.default_start, dtype=torch.float32,
                                  device=self.device)
        self.x0_gen = torch.Generator(device=self.device)
        self.plant_gen = torch.Generator(device=self.device)

    @property
    def run_spec(self) -> dict:
        """The traffic with the episode length: what the reference reads."""
        return {**self.traffic, "steps": self.steps}

    def inputs(self, seed: int, i: int, stream: int = WINDOW) -> BatchInputs:
        """Batch i's inputs under ``seed`` (the same seed, the same inputs)."""
        rng = np.random.default_rng(np.random.SeedSequence(_entropy(seed, stream, i)))
        x0_seed, plant_seed = (int(v) for v in rng.integers(0, 2**62, size=2))
        call_seeds = [int(v) for v in rng.integers(-(2**31), 2**31 - 1, size=self.steps)]
        self.x0_gen.manual_seed(x0_seed)
        noise = torch.randn((self.B, self.start.shape[0]), generator=self.x0_gen,
                            device=self.device)
        x0s = self.start + self.traffic["x0_jitter"] * noise
        return BatchInputs(x0s, call_seeds, plant_seed)

    def run(self, inp: BatchInputs):
        """One batch of closed-loop episodes through the program's entry point."""
        self.plant_gen.manual_seed(inp.plant_seed)
        return self._run(self.env, self.solver, self.episode, inp.x0s,
                         generator=self.plant_gen, use_kernel=True, seeds=inp.call_seeds,
                         device=self.device)
