"""Experiment runner: one configuration of (env, solver, config) run as a
batch of closed-loop episodes, returning the reference's results dict.

Counterpart of ``benchmarking_mpc_solvers_tpu/experiment/experiment.py``,
the entry point of the study scripts. The results dict has the reference's
keys, one for one (name, per-step computation_time, timing_mode,
passed_time, compile_time, the warm start, env states/actions/costs of the
first repetition, the noise flags, the planning histories, and every
repetition's costs in ``batch_costs``), its arrays numpy on the host.

Which tier runs:
- ``fused=True``: ``run_episodes_fused``, the single-kernel tier where the
  solver's ``kernel_ok()`` holds (MPPI, CEM), else the two-stage tier with
  ``solve_batch(use_fused=True)``;
- ``fused=False``, the reference's ``vmap(run_episode)``: iLQR, SQP and I2C
  take the two-stage runner with their kernel stages (where the solver's
  ``has_kernel_stages()`` holds for the model), because the
  reference's vmapped solve reaches its kernels through ``custom_vmap``
  rules (iLQR's and SQP's routed per stage, ``ILQR.stage_routes``); MPPI,
  CEM and QP-MPC, whose vmapped solve reaches no kernel, take
  ``run_episodes_batch``, the plain batched tier. A model the kernel stages
  do not take, or a solver built with ``pallas_backward=False`` (iLQR,
  SQP) or ``pallas_smoother=False`` (I2C), runs plain, as it does in the
  reference.

Timing keeps the reference's meaning: the batch runs twice, the first call
holds the kernel build, the allocator's and the caches' warm-up; the
second is timed between two synchronizations (``passed_time``), and
``compile_time`` is the first call's time less the second's. The
``computation_time`` series is that time over the steps ("amortized").
``timed_per_step=True`` runs one scenario through ``predict_action`` step
by step instead, each solve timed to its synchronization ("per_step").

Randomness comes from ``torch.Generator``s seeded with ``seed``; the draws
differ from the reference's keys, so only deterministic solves (SQP and
QP-MPC from zero plans, without plant noise) match the reference's values.
Entry points run on the card unless ``device="cpu"`` is given.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..device import resolve_device, to_numpy as _np
from ..envs.env import REGISTRY as ENV_REGISTRY
from ..envs.env import Env, NoiseConfig, env_step
from ..solvers import CEM, I2C, ILQR, MPPI, QPMPC, SQP
from ..solvers.base import predict_action
from ..solvers.base import warm_start as do_warm_start
from .episode import EpisodeConfig, run_episodes_batch, run_episodes_fused

SOLVER_REGISTRY = {"CEM": CEM, "MPPI": MPPI, "ILQR": ILQR, "QPMPC": QPMPC, "SQP": SQP, "I2C": I2C}

# reference param name -> our field name, per solver
_PARAM_MAP = {
    "CEM": {"K": "K", "T": "T", "max_iter": "max_iter", "n_elite": "n_elite",
            "epsilon": "epsilon", "alpha": "alpha", "std": "std"},
    "MPPI": {"K": "K", "T": "T", "std": "std", "lam": "lam"},
    "ILQR": {"T": "T", "max_iter": "max_iter", "threshold": "threshold",
             "closed_loop": "closed_loop",
             # numerics and backward-pass variants beyond the upstream set
             "diag_hessian": "diag_hessian", "ddp": "ddp", "box_ddp": "box_ddp",
             "gauss_newton": "gauss_newton",
             "reference_accept": "reference_accept"},
    "QPMPC": {"T": "T", "max_iter": "iters", "method": "method", "rho": "rho",
              "linearize_at": "linearize_at", "init_std": "init_std"},
    "SQP": {"T": "T", "max_iter": "max_iter", "init_std": "init_std"},
    "I2C": {"T": "T", "max_iter": "max_iter", "alpha0": "alpha0",
            "anneal": "anneal", "alpha_max": "alpha_max",
            "sigma_u": "sigma_u", "init_std": "init_std",
            "line_search": "line_search", "prior_lag": "prior_lag"},
}


def make_solver(name: str, model, config: Dict[str, Any], **extra):
    """Build a solver from a reference-style config dict; keys the solver's
    map does not hold are dropped."""
    cls = SOLVER_REGISTRY[name]
    pmap = _PARAM_MAP[name]
    kwargs = {pmap[k]: v for k, v in config.items() if k in pmap}
    kwargs.update(extra)
    return cls(model=model, **kwargs)


class Experiment:
    """One benchmark configuration; ``run()`` executes it.

    params keys (the reference's):
      env: Env instance or registry name
      agent: solver name ("CEM" | "MPPI" | "ILQR" | "QPMPC" | "SQP" | "I2C")
      agent_config: dict with reference-style parameter names
      experiment_length: int
      start_state: array
      actuation_noise / sensor_noise: float stds (0 = off)
      model_noise: bool, inject sensor_noise into the planning model
      seed: int
      repetitions: int, the batch of independent episodes
      timed_per_step: bool, one scenario with each solve timed
      fused: bool, the tier (see the module docstring)
    ``device``: where the episodes run, the card unless "cpu" is asked for.
    """

    def __init__(self, params: Dict[str, Any], device="cuda"):
        env = params["env"]
        self.env: Env = ENV_REGISTRY[env] if isinstance(env, str) else env
        self.agent_name: str = params["agent"]
        self.agent_config: Dict[str, Any] = dict(params["agent_config"])
        self.experiment_length: int = params["experiment_length"]
        self.start_state = np.asarray(params["start_state"], np.float32).reshape(-1)
        self.actuation_noise_std = float(params.get("actuation_noise", 0) or 0)
        self.sensor_noise_std = float(params.get("sensor_noise", 0) or 0)
        self.model_is_noised = bool(params.get("model_noise", False))
        self.seed = int(params.get("seed", 0))
        self.repetitions = int(params.get("repetitions", 1))
        self.timed_per_step = bool(params.get("timed_per_step", False))
        self.fused = bool(params.get("fused", False))
        self.device = resolve_device(device)
        self.params = params
        self.experiment_results: Optional[Dict[str, Any]] = None

    # -- construction ---------------------------------------------------------
    def _build(self):
        extra = {}
        if self.model_is_noised:
            # every solver plans through the noised model, as in the reference
            extra["model_noise_std"] = self.sensor_noise_std
        solver = make_solver(self.agent_name, self.env.model, self.agent_config, **extra)
        noise = NoiseConfig(actuation_std=self.actuation_noise_std,
                            sensor_std=self.sensor_noise_std)
        return solver, noise

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _generator(self) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(self.seed)

    def _common(self, solver, passed_time, computation_time, timing_mode, compile_time,
                ws_trajs) -> Dict[str, Any]:
        model = self.env.model
        return {
            "name": f"{self.agent_name} solving {self.env.name} with {model.name}"
                    f"\n Starting from {self.start_state} Time: {passed_time}",
            "computation_time": computation_time,
            "timing_mode": timing_mode,
            "passed_time": passed_time,
            "compile_time": compile_time,
            "warmstart": ws_trajs is not None,
            "warmstart_trajectories": _np(ws_trajs) if ws_trajs is not None
            else np.zeros((0, solver.T, model.action_size), np.float32),
            "env_name": self.env.name,
            "model_name": model.name,
            "agent_name": self.agent_name,
            "agent_config": self.agent_config,
            "env_start_state": self.start_state.tolist(),
        }

    # -- execution ------------------------------------------------------------
    def _run_timed_per_step(self, solver, noise, warmstart: int):
        """One scenario, step by step: ``predict_action`` (timed to its
        synchronization) and ``env_step``, as the upstream loop times each
        solve."""
        env, dev = self.env, self.device
        model = env.model
        g_z = torch.zeros((solver.T, model.goal_size), dtype=torch.float32, device=dev)
        gen = self._generator()
        sstate = solver.init_state(gen, dev)
        x0 = torch.as_tensor(self.start_state, device=dev)
        ws_trajs = None
        if warmstart > 0:
            sstate, ws_trajs = do_warm_start(solver, sstate, x0, g_z, warmstart)
        # warm the caches off the clock, leaving the generator where it was
        gen_state = gen.get_state()
        predict_action(solver, sstate, x0, g_z)
        self._sync()
        gen.set_state(gen_state)

        x_true = obs = x0
        computation_time, records = [], []
        for _ in range(self.experiment_length):
            self._sync()
            t0 = time.perf_counter()
            out = predict_action(solver, sstate, obs, g_z)
            self._sync()
            computation_time.append(round(time.perf_counter() - t0, 6))
            sstate = out.state
            es = env_step(env, x_true, out.action, noise, gen)
            x_true, obs = es.true_state, es.observation
            records.append((obs, es, out))

        passed_time = round(float(np.sum(computation_time)), 6)
        out_dict = self._common(solver, passed_time, computation_time, "per_step", 0.0,
                                ws_trajs)
        out_dict.update({
            "env_states": np.stack([_np(r[0]) for r in records]),
            "env_actions": np.stack([_np(r[1].action) for r in records]),
            "env_costs": np.array([float(r[1].cost) for r in records]),
            "actuation_noise": self.actuation_noise_std > 0,
            "sensor_noise": self.sensor_noise_std > 0,
            "model_noise": self.model_is_noised,
            "agent_planning_states": np.stack([_np(r[2].planned_xs) for r in records]),
            "agent_planning_actions": np.stack([_np(r[2].planned_us) for r in records]),
            "agent_planning_costs": np.array([float(r[2].planned_cost) for r in records]),
            "repetitions": 1,
        })
        if self.sensor_noise_std > 0:
            out_dict["env_true_states"] = np.stack([_np(r[1].true_state) for r in records])
            out_dict["sensor_noise_std"] = self.sensor_noise_std
        if self.actuation_noise_std > 0:
            out_dict["env_true_actions"] = np.stack([_np(r[1].true_action) for r in records])
            out_dict["actuation_noise_std"] = self.actuation_noise_std
        self.experiment_results = out_dict
        return out_dict

    def _episodes(self, solver, cfg: EpisodeConfig):
        """The repetition batch's episodes on this configuration's tier,
        from a generator seeded with ``seed``."""
        dev = self.device
        x0s = torch.as_tensor(self.start_state, device=dev).expand(
            self.repetitions, -1).contiguous()
        gen = self._generator()
        if self.fused:
            return run_episodes_fused(self.env, solver, cfg, x0s, generator=gen, device=dev)
        if solver.has_kernel_stages():
            # the two-stage runner with solve_batch(use_fused=True)
            return run_episodes_fused(self.env, solver, cfg, x0s, generator=gen,
                                      use_kernel=False, device=dev)
        return run_episodes_batch(self.env, solver, cfg, x0s, generator=gen, device=dev)

    def run(self, warmstart: Optional[int] = None) -> Dict[str, Any]:
        solver, noise = self._build()
        if self.timed_per_step:
            return self._run_timed_per_step(solver, noise, warmstart or 0)
        cfg = EpisodeConfig(n_steps=self.experiment_length, warmstart=warmstart or 0,
                            noise=noise, record_plans=True)
        self._sync()
        t0 = time.perf_counter()
        self._episodes(solver, cfg)
        self._sync()
        first = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = self._episodes(solver, cfg)
        self._sync()
        steady = time.perf_counter() - t0

        # amortized: a constant series (the timed call over the steps), not
        # per-step latencies; timed_per_step=True measures those
        per_step = steady / self.experiment_length
        passed_time = round(steady, 6)
        ws = res.warmstart_trajectories
        out = self._common(solver, passed_time, [round(per_step, 6)] * self.experiment_length,
                           "amortized", round(first - steady, 3),
                           None if ws is None else ws[0])
        out.update({
            "env_states": _np(res.observations[0]),
            "env_actions": _np(res.actions[0]),
            "env_costs": _np(res.costs[0]),
            "actuation_noise": self.actuation_noise_std > 0,
            "sensor_noise": self.sensor_noise_std > 0,
            "model_noise": self.model_is_noised,
            "agent_planning_states": _np(res.planned_states[0]),
            "agent_planning_actions": _np(res.planned_actions[0]),
            "agent_planning_costs": _np(res.planned_costs[0]),
            # every repetition, beyond the upstream schema
            "batch_costs": _np(res.costs),
            "batch_total_costs": _np(res.costs.sum(dim=-1)),
            "repetitions": self.repetitions,
        })
        if self.sensor_noise_std > 0:
            out["env_true_states"] = _np(res.true_states[0, 1:])
            out["sensor_noise_std"] = self.sensor_noise_std
        if self.actuation_noise_std > 0:
            out["env_true_actions"] = _np(res.true_actions[0])
            out["actuation_noise_std"] = self.actuation_noise_std
        self.experiment_results = out
        return out

    def __call__(self, warmstart: Optional[int] = None) -> Dict[str, Any]:
        return self.run(warmstart=warmstart)
