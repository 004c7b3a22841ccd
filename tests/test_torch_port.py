"""The port stands alone: no JAX, nothing of the reference package, and
entry points that run on the card unless asked for the CPU."""

import os
import pathlib
import pkgutil
import subprocess
import sys

import pytest
import torch

import benchmarking_mpc_solvers_tpu_torch as port
import kernel_ab
from benchmarking_mpc_solvers_tpu_torch.envs import CartPoleSwingUpEnv
from benchmarking_mpc_solvers_tpu_torch.experiment import (
    EpisodeConfig,
    run_episode,
    run_episodes_batch,
    run_episodes_fused,
)
from benchmarking_mpc_solvers_tpu_torch import convert, estimation
from benchmarking_mpc_solvers_tpu_torch.solvers import CEM, I2C, ILQR, MPPI, QPMPC, SQP

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_DIR = ROOT / "benchmarking_mpc_solvers_tpu_torch"
REFERENCE = "benchmarking_mpc_solvers_tpu"


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + "."))


def test_port_imports_neither_jax_nor_reference():
    mods = _port_modules()
    assert "benchmarking_mpc_solvers_tpu_torch.experiment.episode" in mods
    for new in ("solvers.i2c", "ops.i2c_smooth", "models.synthetic", "estimation",
                "estimation.kalman", "estimation.quadrature", "estimation.cubature",
                "parallel.mesh", "parallel.mppi_sharded", "parallel.distributed",
                "utils.checkpoint", "utils.profiling", "utils.logging", "envs.render",
                "envs.gym_wrapper"):
        assert f"benchmarking_mpc_solvers_tpu_torch.{new}" in mods, new
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        f"       or m == {REFERENCE!r} or m.startswith({REFERENCE + '.'!r})]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize("path", sorted(
    [p for p in PORT_DIR.rglob("*") if p.suffix in (".py", ".cu", ".cuh")]
    + [ROOT / "chip_smoke.py", ROOT / "kernel_ab.py"]), ids=lambda p: str(p.relative_to(ROOT)))
def test_port_sources_do_not_import_jax_or_reference(path):
    text = path.read_text()
    for line in text.splitlines():
        stripped = line.strip()
        if stripped.startswith(("import ", "from ")):
            words = stripped.replace(",", " ").split()
            assert "jax" not in words and not any(
                w == REFERENCE or w.startswith(REFERENCE + ".") for w in words), line
            assert not any(w.startswith("jax.") for w in words), line


@pytest.mark.parametrize("source", sorted(kernel_ab.CASES))
def test_kernel_ab_refuses_to_run_without_a_card(source):
    out = subprocess.run([sys.executable, "kernel_ab.py", source, "-D", "UNUSED=1"],
                         cwd=ROOT, capture_output=True, text=True, timeout=120,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert "needs a CUDA card" in out.stdout
    assert not out.stdout.strip().splitlines()[-1].startswith("{")


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    """With no CUDA, the default device raises instead of moving to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    env = CartPoleSwingUpEnv
    solver = MPPI(model=env.model, T=4, K=4)
    cfg = EpisodeConfig(n_steps=1, record_plans=False)
    x0s = env.start_state("cpu").expand(2, -1)
    for call in (lambda: run_episodes_fused(env, solver, cfg, x0s),
                 lambda: env.start_state(),
                 lambda: solver.goal_traj(cfg.goal_state),
                 lambda: run_episodes_batch(env, solver, cfg, x0s),
                 lambda: run_episode(env, solver, cfg),
                 lambda: solver.init_state(torch.Generator()),
                 lambda: solver.init_state_batch(2, torch.Generator()),
                 lambda: CEM(model=env.model, T=4).init_state_batch(2, torch.Generator()),
                 lambda: ILQR(model=env.model, T=4).init_state(torch.Generator()),
                 lambda: ILQR(model=env.model, T=4).init_state_batch(2, torch.Generator()),
                 lambda: SQP(model=env.model, T=4).init_state(torch.Generator()),
                 lambda: SQP(model=env.model, T=4).init_state_batch(2, torch.Generator()),
                 lambda: QPMPC(model=env.model, T=4).init_state(torch.Generator()),
                 lambda: QPMPC(model=env.model, T=4).init_state_batch(2, torch.Generator()),
                 lambda: run_episodes_fused(env, SQP(model=env.model, T=4), cfg, x0s),
                 lambda: run_episodes_fused(env, QPMPC(model=env.model, T=4), cfg, x0s),
                 lambda: I2C(model=env.model, T=4).init_state(torch.Generator()),
                 lambda: I2C(model=env.model, T=4).init_state_batch(2, torch.Generator()),
                 lambda: run_episodes_fused(env, I2C(model=env.model, T=4), cfg, x0s),
                 lambda: convert.i2c_state_from_numpy([[0.0]] * 4),
                 lambda: convert.i2c_problem_from_numpy(*[[0.0]] * 9),
                 lambda: estimation.default_sigma_points(2),
                 lambda: estimation.make_pendulum_ukf()):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
