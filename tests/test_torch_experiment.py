"""Port vs reference: the experiment host layer (``Experiment``,
``ResultStore``, tables and plots).

- ``_PARAM_MAP`` and ``SOLVER_REGISTRY`` equal the reference's.
- The results dict has the reference's keys: the reference builds one key
  set per timing mode and set of noise flags, whatever the solver and tier
  (``experiment/experiment.py:167-201``, ``:247-281``), so it is taken from
  a cheap reference run per flag set and held against the port's for all
  six solvers, both tiers.
- Values match the reference where the solve is deterministic (SQP and
  QP-MPC from zero plans, no plant noise), to the tolerances of
  ``tests/test_torch_sqp.py`` (2e-3) and ``tests/test_torch_qp_mpc.py``
  (1e-3).
- A store written by either package is read by the other, and both
  packages' ``generate_tables`` write the same LaTeX from the same results.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmarking_mpc_solvers_tpu import experiment as jexp
from benchmarking_mpc_solvers_tpu.experiment import experiment as jexp_mod
from benchmarking_mpc_solvers_tpu_torch import experiment as texp
from benchmarking_mpc_solvers_tpu_torch.experiment import experiment as texp_mod
from benchmarking_mpc_solvers_tpu_torch.envs import REGISTRY as TENVS
from benchmarking_mpc_solvers_tpu_torch.models import make_dummy_model
from benchmarking_mpc_solvers_tpu_torch.solvers import ILQR

SQP_TOL, QP_TOL = 2e-3, 1e-3

SOLVERS = {
    "MPPI": ("pendulum", {"K": 8, "T": 4, "std": 1.0, "lam": 1.0}, [3.0, 0.0]),
    "CEM": ("cartpole_swingup", {"K": 8, "T": 4, "n_elite": 2, "max_iter": 2},
            [0.0, 0.0, 3.1, 0.0]),
    "ILQR": ("pendulum", {"T": 4, "max_iter": 2}, [3.0, 0.0]),
    "SQP": ("acrobot", {"T": 4, "max_iter": 2}, [0.1, 0.0, 0.2, 0.0]),
    "QPMPC": ("pendulum", {"T": 4, "max_iter": 10}, [0.4, -0.3]),
    "I2C": ("pendulum", {"T": 4, "max_iter": 2}, [3.0, 0.0]),
}
NOISE_FLAGS = {
    "clean": {},
    "sensor+model": {"sensor_noise": 0.1, "model_noise": True},
    "actuation+sensor": {"actuation_noise": 0.1, "sensor_noise": 0.1},
}


def _params(agent, length=2, repetitions=2, **extra):
    env, cfg, start = SOLVERS[agent]
    return dict(env=env, agent=agent, agent_config=cfg, experiment_length=length,
                start_state=start, repetitions=repetitions, **extra)


def test_param_map_and_registry_match_reference():
    assert texp_mod._PARAM_MAP == jexp_mod._PARAM_MAP
    assert sorted(texp.SOLVER_REGISTRY) == sorted(jexp.SOLVER_REGISTRY)
    # a key outside the map (scripts/sample_test.py passes elite_ratio) is dropped
    solver = texp.make_solver("CEM", TENVS["pendulum"].model,
                              {"K": 8, "T": 4, "elite_ratio": 0.1, "n_elite": 2})
    assert (solver.K, solver.T, solver.n_elite) == (8, 4, 2)


@pytest.fixture(scope="module")
def reference_keys():
    """The reference's key set per noise-flag set (amortized) and per
    timing mode, from its cheapest solver."""
    keys = {}
    for flags, extra in NOISE_FLAGS.items():
        keys[flags] = sorted(jexp.Experiment(_params("MPPI", **extra)).run())
    keys["per_step"] = sorted(jexp.Experiment(_params("MPPI", timed_per_step=True)).run())
    return keys


@pytest.mark.parametrize("flags", sorted(NOISE_FLAGS))
@pytest.mark.parametrize("agent", sorted(SOLVERS))
def test_results_have_the_reference_keys(reference_keys, agent, flags):
    for fused in (False, True):
        res = texp.Experiment(_params(agent, fused=fused, **NOISE_FLAGS[flags]),
                              device="cpu").run(warmstart=1)
        assert sorted(res) == reference_keys[flags], (agent, fused)
        assert not any(isinstance(v, torch.Tensor) for v in res.values())
        assert res["timing_mode"] == "amortized" and res["repetitions"] == 2
        assert res["batch_costs"].shape == (2, 2) and res["env_costs"].dtype == np.float32
        assert res["warmstart_trajectories"].shape == (1, 4, 1)
        assert res["passed_time"] > 0 and len(res["computation_time"]) == 2


def test_smoke_script_keeps_the_reference_keys(reference_keys):
    """chip_smoke.py checks the card's results against its own copy of the
    reference's key sets (the card's machine has no JAX)."""
    import chip_smoke

    assert chip_smoke.experiment_keys(False, False, False) == reference_keys["clean"]
    assert chip_smoke.experiment_keys(True, False, False) == reference_keys["sensor+model"]
    assert chip_smoke.experiment_keys(True, True, False) == reference_keys["actuation+sensor"]
    assert chip_smoke.experiment_keys(False, False, True) == reference_keys["per_step"]


def test_timed_per_step_has_the_reference_keys(reference_keys):
    res = texp.Experiment(_params("ILQR", length=3, timed_per_step=True),
                          device="cpu").run(warmstart=1)
    assert sorted(res) == reference_keys["per_step"]
    assert res["timing_mode"] == "per_step" and len(res["computation_time"]) == 3
    assert res["env_states"].shape == (3, 2) and res["agent_planning_actions"].shape == (3, 4, 1)
    # the warm-up call off the clock leaves the generator's draws alone
    again = texp.Experiment(_params("ILQR", length=3, timed_per_step=True),
                            device="cpu").run(warmstart=1)
    np.testing.assert_array_equal(again["env_states"], res["env_states"])


@pytest.mark.parametrize("agent,fused,tol", [("SQP", False, SQP_TOL), ("QPMPC", False, QP_TOL),
                                             ("QPMPC", True, QP_TOL)])
def test_deterministic_values_match_reference(agent, fused, tol):
    env, cfg, start = SOLVERS[agent]
    params = dict(env=env, agent=agent, agent_config=dict(cfg, T=6), experiment_length=3,
                  start_state=start, repetitions=2, fused=fused)
    want = jexp.Experiment(params).run(warmstart=1)
    got = texp.Experiment(params, device="cpu").run(warmstart=1)
    for key, w in want.items():
        if isinstance(w, np.ndarray) and key != "computation_time":
            np.testing.assert_allclose(got[key], w, rtol=tol, atol=tol, err_msg=key)
    assert float(np.abs(got["env_actions"]).max()) > 0.01  # the plans moved
    for key in ("env_name", "model_name", "agent_name", "agent_config", "env_start_state",
                "warmstart", "repetitions"):
        assert got[key] == want[key], key
    assert got["name"].split(" Time:")[0] == want["name"].split(" Time:")[0]


@pytest.mark.parametrize("agent,fused,tier", [
    ("ILQR", False, "two-stage"), ("SQP", False, "two-stage"), ("I2C", False, "two-stage"),
    ("MPPI", False, "plain"), ("CEM", False, "plain"), ("QPMPC", False, "plain"),
    ("MPPI", True, "fused"), ("ILQR", True, "fused")])
def test_tier_of_each_solver(monkeypatch, agent, fused, tier):
    """``fused=False`` takes the two-stage runner with the kernel stages for
    the solvers whose vmapped reference solve reaches kernels, the plain
    batched tier for the others; ``fused=True`` takes run_episodes_fused."""
    seen = []
    real_fused, real_batch = texp_mod.run_episodes_fused, texp_mod.run_episodes_batch

    def fused_tier(*a, use_kernel=True, **k):
        seen.append("fused" if use_kernel else "two-stage")
        return real_fused(*a, use_kernel=use_kernel, **k)

    def plain_tier(*a, **k):
        seen.append("plain")
        return real_batch(*a, **k)

    monkeypatch.setattr(texp_mod, "run_episodes_fused", fused_tier)
    monkeypatch.setattr(texp_mod, "run_episodes_batch", plain_tier)
    texp.Experiment(_params(agent, length=1, fused=fused), device="cpu").run()
    assert seen == [tier, tier]


def test_solvers_report_their_kernel_stages():
    """Each solver says whether its batched solve has kernel stages for the
    model, which picks the ``fused=False`` tier: iLQR, SQP and I2C for a
    model their kernels take, never MPPI, CEM or QP-MPC."""
    for agent, (env, cfg, _) in SOLVERS.items():
        solver = texp.make_solver(agent, TENVS[env].model, cfg)
        assert solver.has_kernel_stages() == (agent in ("ILQR", "SQP", "I2C")), agent
    wide = make_dummy_model(2, 2)  # an action the Riccati kernel does not take
    assert not texp.make_solver("ILQR", wide, {"T": 4}).has_kernel_stages()
    assert not texp.make_solver("SQP", wide, {"T": 4}).has_kernel_stages()
    assert texp.make_solver("I2C", wide, {"T": 4}).has_kernel_stages()  # any action size


def test_experiment_runs_on_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        texp.Experiment(_params("MPPI"))


def _result(agent="MPPI", T=5, K=10, seed=0):
    rng = np.random.default_rng(seed)
    return {"name": f"{agent} run", "env_name": "PendulumEnvironment", "agent_name": agent,
            "agent_config": {"T": T, "K": K}, "passed_time": 0.25 + seed,
            "computation_time": [0.1, 0.15], "repetitions": 3, "warmstart": False,
            "env_costs": rng.standard_normal(4).astype(np.float32),
            "batch_costs": rng.standard_normal((3, 4)).astype(np.float32),
            "env_states": torch.from_numpy(rng.standard_normal((4, 2)).astype(np.float32)),
            "count": np.int64(7)}


def test_store_written_by_either_package_is_read_by_the_other(tmp_path):
    port_store = texp.ResultStore(str(tmp_path), "port")
    port_store.insert(_result("MPPI", T=5, seed=0))
    port_store.insert(_result("CEM", T=10, seed=1))
    read = jexp.ResultStore(str(tmp_path), "port")
    (got,) = read.find({"agent_config.T": 10})
    want = _result("CEM", T=10, seed=1)
    np.testing.assert_array_equal(got["env_states"], want["env_states"].numpy())
    np.testing.assert_array_equal(got["batch_costs"], want["batch_costs"])
    assert got["count"] == 7 and got["agent_config"] == {"T": 10, "K": 10}

    ref_store = jexp.ResultStore(str(tmp_path), "reference")
    for i, agent in enumerate(("MPPI", "CEM", "ILQR")):
        r = _result(agent, T=5 * (i + 1), seed=i)
        r["env_states"] = r["env_states"].numpy()
        ref_store.insert(r)
    mine = texp.ResultStore(str(tmp_path), "reference")
    assert mine.count() == 3
    assert mine.count({"agent_name": {"$in": ["CEM", "ILQR"]}}) == 2
    assert mine.count({"agent_config.T": {"$gt": 5}}) == 2
    assert mine.count({"agent_config.T": {"$lt": 15}}) == 2
    assert mine.count({"agent_name": {"$ne": "MPPI"}, "agent_config.T": 15}) == 1
    (ilqr,) = mine.find({"agent_name": "ILQR"})
    np.testing.assert_array_equal(ilqr["env_costs"], _result("ILQR", T=15, seed=2)["env_costs"])
    assert [m["agent_name"] for m in mine.find(arrays=False)] == ["MPPI", "CEM", "ILQR"]


def test_generate_tables_writes_the_reference_latex(tmp_path):
    results = [_result(agent, T=T, K=K, seed=s) for s, (agent, T, K) in enumerate(
        [("MPPI", 5, 10), ("MPPI", 10, 20), ("CEM", 5, 10), ("ILQR", 10, 50)])]
    paths = {}
    for name, pkg in (("port", texp), ("reference", jexp)):
        store = pkg.ResultStore(str(tmp_path / name), "runs")
        for r in results:
            store.insert(dict(r, env_states=r["env_states"].numpy()))
        paths[name] = pkg.generate_tables([store], str(tmp_path / name / "tables"))
    assert len(paths["port"]) == 2
    for p, q in zip(paths["port"], paths["reference"]):
        assert open(p).read() == open(q).read()
    agg = texp.aggregate(results[:2])
    assert agg == jexp.aggregate(results[:2])


def test_plots_write_their_files(tmp_path):
    res = texp.Experiment(_params("ILQR", length=3), device="cpu").run(warmstart=1)
    fig = texp.plot_experiment(res, plot_planning=True)
    fig.savefig(tmp_path / "one.png")
    texp.plot_experiments([res, res]).savefig(tmp_path / "two.png")
    texp.plot_cost_bands({"ILQR": {"x": [5, 10], "median": [1.0, 0.5], "q25": [0.8, 0.4],
                                   "q75": [1.2, 0.7]}}, xlabel="T").savefig(tmp_path / "bands.png")
    for name in ("one.png", "two.png", "bands.png"):
        assert (tmp_path / name).stat().st_size > 0
    model = TENVS["pendulum"].model
    solver = ILQR(model=model, T=4, max_iter=2, n_alphas=3)
    st = solver.init_state(torch.Generator().manual_seed(0), "cpu")
    written = texp.plot_ilqr_line_search(solver, st, torch.tensor([3.0, 0.0]),
                                         torch.zeros((4, model.goal_size)), str(tmp_path / "ls"))
    assert written and all(open(p, "rb").read(4) == b"\x89PNG" for p in written)


def test_package_and_smoke_script_import_without_pandas_or_matplotlib():
    """The card's machine has neither: the experiment package imports
    ``plot`` only on first use and pandas only when a table is pivoted, and
    chip_smoke.py imports neither."""
    code = (
        "import sys\n"
        "sys.modules['pandas'] = None\n"
        "sys.modules['matplotlib'] = None\n"
        "import benchmarking_mpc_solvers_tpu_torch.experiment as e\n"
        "import chip_smoke\n"
        "assert e.Experiment and e.ResultStore and e.aggregate\n"
        "try:\n"
        "    e.plot_cost_bands\n"
        "except ImportError:\n"
        "    pass\n"
        "else:\n"
        "    raise AssertionError('plot imported without matplotlib')\n"
        "try:\n"
        "    e.generate_tables([], 'unused')\n"
        "except ImportError:\n"
        "    print('ok')\n"
    )
    root = __import__("pathlib").Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
