"""The port's benchmark entry points against the JAX package's, on the CPU.

``benchmarking_mpc_solvers_tpu_torch/scripts/bench_suite.py`` against
``scripts/bench_suite.py``, and ``.../scripts/bench.py`` against the root
``bench.py``:

- each configuration's solver (class and every field), episode (n_steps,
  warm start), batch, horizon, start state and timing chains equal the JAX
  script's, full and ``--quick``: captured from the JAX script's ``main``
  with its episode, timing and latency functions replaced, so that none of
  its episodes runs;
- a ``--quick --device cpu`` run of the port prints six lines with the JAX
  script's keys, and configuration 5 names the JAX script's paths;
- configurations 1 and 2 are deterministic: their median episode cost at
  quick widths against the JAX package's episodes of the same solvers, at
  ``tests/test_torch_qp_mpc.py``'s tolerance (5e-4);
- the port's ``bench`` line from injected timings, with the JAX script's
  reference rate;
- both entry points run on the card unless asked for the CPU.
"""

import collections
import dataclasses
import importlib.util
import json
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import benchmarking_mpc_solvers_tpu.experiment as jexperiment
import benchmarking_mpc_solvers_tpu.parallel as jparallel
from benchmarking_mpc_solvers_tpu.experiment import run_episode as j_run_episode
from benchmarking_mpc_solvers_tpu_torch.experiment import run_episodes_fused
from benchmarking_mpc_solvers_tpu_torch.scripts import bench, bench_suite

ROOT = pathlib.Path(__file__).resolve().parents[1]
QP_TOL = 5e-4  # tests/test_torch_qp_mpc.py
BASE_KEYS = {"config", "solves_per_sec", "p50_step_latency_ms", "p90_step_latency_ms",
             "amortized_step_ms", "episode_cost", "constraint_violation"}
EXTRA_KEYS = {2: {"max_final_pole_angle_rad"},
              5: {"median_costs", "solves_per_sec_by_solver", "episode_path_by_solver"}}


def _load(monkeypatch, path, name):
    monkeypatch.setenv("BMPC_COMPILE_CACHE", "")
    monkeypatch.delenv("BMPC_PLATFORM", raising=False)
    monkeypatch.syspath_prepend(str(ROOT / "scripts"))
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


FakeResult = collections.namedtuple("FakeResult", "costs true_states true_actions")


def _fake_result(B, steps, S):
    return FakeResult(jnp.zeros((B, steps)), jnp.zeros((B, steps, S)),
                      jnp.zeros((B, steps, 1)))


def capture_jax_suite(monkeypatch, quick):
    """The JAX script's configurations, without running an episode: per
    configuration (in its order), its rows [(name, env, solver, cfg)], B,
    the start states, the timing chains [(inner, outer)] and its report's
    extra keys."""
    mod = _load(monkeypatch, ROOT / "scripts" / "bench_suite.py", "jax_bench_suite")
    confs, cur = [], {}

    def new(**kw):
        cur.clear()
        cur.update(rows=[], timing=[], **kw)

    def episode_metrics(env, solver, cfg, B, quick, inner=None, x0s=None):
        new(B=B, x0s=np.asarray(jnp.tile(env.start_state, (B, 1)) if x0s is None else x0s))
        cur["rows"].append((type(solver).__name__, env, solver, cfg))
        cur["timing"].append((inner or (3 if quick else 9), 1 if quick else 3))
        # its step_latency_dist(..., n=5 if quick else 30), inside it
        cur["latency"] = (type(solver).__name__, 5 if quick else 30)
        return None, (None, None, None), 0.0, 0.0

    def timed_per_call(fn, inner_reps, outer_reps):
        if not cur or cur.get("done"):
            new()
        cur["timing"].append((inner_reps, outer_reps))
        return None

    def step_latency_dist(env, solver, cfg, B, x0s, fused=False, n=30):
        cur.update(B=B, x0s=np.asarray(x0s), latency=(type(solver).__name__, n))
        if not cur["rows"]:  # configuration 2: its solver is seen here
            cur["rows"].append((type(solver).__name__, env, solver, cfg))
        return None, None

    def report(name, solves_per_sec, lat, cost, viol, extra=None):
        cur.update(name=name, extra=extra or {}, done=True)
        confs.append(dict(cur))

    def sharded_episodes(env, solver, cfg, mesh):
        if not cur or cur.get("done"):
            new()
        cur["rows"].append((type(solver).__name__, env, solver, cfg))
        return lambda keys, x0s: _fake_result(x0s.shape[0], cfg.n_steps, x0s.shape[1])

    def run_episodes_fused(env, solver, cfg, keys, x0s, **kw):
        B = x0s.shape[0]
        return _fake_result(B, cfg.n_steps, x0s.shape[1])

    monkeypatch.setattr(mod, "episode_metrics", episode_metrics)
    monkeypatch.setattr(mod, "timed_per_call", timed_per_call)
    monkeypatch.setattr(mod, "step_latency_dist", step_latency_dist)
    monkeypatch.setattr(mod, "report", report)
    monkeypatch.setattr(jparallel, "sharded_episodes", sharded_episodes)
    monkeypatch.setattr(jparallel, "sharded_episodes_kernel", lambda *a, **k: None)
    monkeypatch.setattr(jexperiment, "run_episodes_fused", run_episodes_fused)
    monkeypatch.setattr(sys, "argv", ["bench_suite"] + (["--quick"] if quick else []))
    mod.main()
    return confs


def _same_solver(port, ref):
    assert type(port).__name__ == type(ref).__name__
    for f in dataclasses.fields(ref):
        want, got = getattr(ref, f.name), getattr(port, f.name)
        if f.name == "model":
            assert got.name == want.name and got.state_size == want.state_size
        else:
            assert got == want, (type(ref).__name__, f.name, got, want)


@pytest.mark.parametrize("quick", [False, True], ids=["full", "quick"])
def test_configurations_match_the_jax_script(monkeypatch, quick):
    ref = capture_jax_suite(monkeypatch, quick)
    n_dev = len(jax.devices())
    port = bench_suite.configurations(quick, n_dev)
    assert [c.name for c in port] == [r["name"] for r in ref] and len(port) == 6
    for conf, r in zip(port, ref):
        assert conf.B == r["B"], conf.key
        x0 = (np.asarray(conf.env.default_start, np.float32) if conf.x0 is None
              else np.asarray(conf.x0, np.float32))
        np.testing.assert_array_equal(np.tile(x0, (conf.B, 1)), r["x0s"])
        assert [label for label, _ in conf.rows] == [row[0] for row in r["rows"]]
        for (label, solver), (_, env, jsolver, jcfg) in zip(conf.rows, r["rows"]):
            assert conf.env.name == env.name
            _same_solver(solver, jsolver)
            assert (conf.cfg.n_steps, conf.cfg.warmstart, conf.cfg.record_plans) == (
                jcfg.n_steps, jcfg.warmstart, jcfg.record_plans), label
        assert {(conf.inner, conf.outer)} == set(r["timing"]), conf.key
        lat_solver = conf.latency_solver or conf.rows[0][1]
        assert (type(lat_solver).__name__, conf.latency_n) == r["latency"]
        if conf.latency_solver is not None:
            _same_solver(conf.latency_solver, r["rows"][0][2])
        assert set(r["extra"]) == EXTRA_KEYS.get(conf.key, set())
        if conf.key == 5:
            paths = {label: bench_suite.jax_path(label, s) for label, s in conf.rows}
            assert paths == r["extra"]["episode_path_by_solver"]


def test_quick_cpu_run_prints_the_jax_scripts_lines(tmp_path, capsys):
    seen = []
    lines = bench_suite.main(["--quick", "--device", "cpu", "--results-dir", str(tmp_path)],
                             before=lambda conf: seen.append(conf.key))
    assert seen == [1, 2, 3, 4, 5, 6]
    printed = [json.loads(x) for x in capsys.readouterr().out.splitlines()
               if x.startswith("{")]
    assert printed == lines and len(lines) == 6
    saved = (tmp_path / "measure" / "bench_suite.jsonl").read_text().splitlines()
    assert [json.loads(x) for x in saved] == lines
    for key, rec in zip(range(1, 7), lines):
        want = BASE_KEYS | EXTRA_KEYS.get(key, set())
        assert set(rec) == (want | {"episode_route_by_solver"} if key == 5 else want), key
        assert np.isfinite(rec["episode_cost"])
    paths = lines[4]["episode_path_by_solver"]
    assert paths == {"MPPI": "single_kernel", "CEM": "single_kernel", "QPMPC": "solve_batch",
                     "ILQR": "vmapped_scalar", "SQP": "vmapped_scalar",
                     "I2C": "vmapped_scalar"}
    assert set(lines[4]["median_costs"]) == set(paths)


@pytest.mark.parametrize("key", [1, 2])
def test_deterministic_configurations_match_the_jax_costs(monkeypatch, key):
    """The quick widths of configurations 1 and 2: the port's batched
    episodes on the CPU against the JAX package's (its script's path: the
    vmapped scalar episode for 1, ``run_episodes_fused`` for 2), median
    episode cost and every scenario's costs."""
    ref = capture_jax_suite(monkeypatch, True)[key - 1]
    monkeypatch.undo()
    conf = bench_suite.configurations(True)[key - 1]
    _, jenv, jsolver, jcfg = ref["rows"][0]
    keys = jax.random.split(jax.random.PRNGKey(0), conf.B)
    x0s = jnp.asarray(ref["x0s"])
    if key == 1:
        want = jax.vmap(lambda k, x: j_run_episode(jenv, jsolver, jcfg, k, x))(keys, x0s)
    else:
        want = jexperiment.run_episodes_fused(jenv, jsolver, jcfg, keys, x0s)
    want = np.asarray(want.costs).sum(axis=-1)
    got = run_episodes_fused(conf.env, conf.rows[0][1], conf.cfg,
                             torch.tensor(ref["x0s"]), device="cpu")
    got = got.costs.sum(dim=-1).numpy()
    np.testing.assert_allclose(got, want, rtol=QP_TOL, atol=QP_TOL)
    np.testing.assert_allclose(np.median(got), np.median(want), rtol=QP_TOL, atol=QP_TOL)


def test_bench_line_from_injected_timings(monkeypatch, capsys):
    jbench = _load(monkeypatch, ROOT / "bench.py", "jax_bench")
    asked = []

    def timer(fn, inner_reps, outer_reps, device):
        asked.append((inner_reps, outer_reps, device.type))
        return 0.5

    rec = bench.main(["--device", "cpu"], timer=timer)
    assert asked == [(jbench.INNER_REPS, jbench.OUTER_REPS, "cpu")] == [(9, 3, "cpu")]
    assert json.loads(capsys.readouterr().out.strip()) == rec
    assert bench.REFERENCE_SOLVES_PER_SEC == jbench.REFERENCE_SOLVES_PER_SEC
    assert (bench.HORIZON, bench.K_SAMPLES, bench.BATCH, bench.N_STEPS) == (
        jbench.HORIZON, jbench.K_SAMPLES, jbench.BATCH, jbench.N_STEPS)
    solves = jbench.BATCH * jbench.N_STEPS / 0.5
    assert rec["value"] == round(solves, 1) and rec["unit"] == "solves/s"
    assert rec["vs_baseline"] == round(solves / jbench.REFERENCE_SOLVES_PER_SEC, 1)
    assert set(rec) == {"metric", "value", "unit", "vs_baseline"}


@pytest.mark.parametrize("entry", ["bench_suite", "bench"])
def test_entry_points_run_on_the_card_unless_asked(entry):
    mod = {"bench_suite": bench_suite, "bench": bench}[entry]
    if entry == "bench_suite":
        assert mod.parser().parse_args([]).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            mod.main([])
