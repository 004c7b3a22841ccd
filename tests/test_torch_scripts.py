"""Port vs reference: the study entry points (the JAX package's ``scripts/``
against ``benchmarking_mpc_solvers_tpu_torch/scripts/``).

- Grids: each of the seven sweep scripts' ``grid(args)`` yields the
  sequence of ``(collection, params, warmstart)`` that the JAX script hands
  its ``run_and_store`` (captured by replacing it in the script's module),
  in full mode and in ``--quick`` mode; every full-mode configuration is
  already marked done in the JAX package's checkpoints under ``results/``,
  so the checkpoint keys are the JAX package's too.
- Runs: each port sweep ``--quick --device cpu --no-plots`` fills its
  collections with one record a configuration, each with the reference's
  results keys, and a second call skips every configuration.
- Values: the two deterministic quick cells (goal-linearized QPMPC, which
  has no random init, and experiment_test's SQP from zero plans, which
  stays at its start in both packages) against the JAX package's
  ``Experiment`` on the CPU, to the tolerances of
  ``tests/test_torch_qp_mpc.py`` and ``tests/test_torch_sqp.py``; and
  new_solver_sweep's quick SQP cell, whose closed loop moves, from the JAX
  package's initial plans.
- Host scripts: both packages' ``table_generation`` and ``quality_parity``
  on the committed ``results/`` (read only) give the same LaTeX files and
  the same table rows; ``purge_nonfinite`` leaves the same index and
  checkpoint as the JAX script's on a copy of a collection; ``test_store``
  and ``difftools`` run on the CPU.
- The quality cells the card missed: the port's closed loop at their
  configuration against the JAX package's from injected plans, over a
  short episode.
"""

import importlib.util
import json
import pathlib
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from benchmarking_mpc_solvers_tpu import experiment as jexp
from benchmarking_mpc_solvers_tpu.envs import REGISTRY as JENVS
from benchmarking_mpc_solvers_tpu.experiment import EpisodeConfig as JConfig
from benchmarking_mpc_solvers_tpu.experiment.episode import run_episodes_batch as j_batch
from benchmarking_mpc_solvers_tpu.solvers import ILQR as JILQR
from benchmarking_mpc_solvers_tpu_torch import experiment as texp
from benchmarking_mpc_solvers_tpu_torch.envs import REGISTRY as TENVS
from benchmarking_mpc_solvers_tpu_torch.experiment import (
    EpisodeConfig, ResultStore, run_episodes_fused)
from benchmarking_mpc_solvers_tpu_torch.solvers import ILQR as TILQR
from benchmarking_mpc_solvers_tpu_torch.scripts import (
    _common,
    difftools,
    experiment_test,
    ilqr_modern_cells,
    ilqr_tuning,
    mppi_temperature,
    new_solver_sweep,
    noise_tests,
    purge_nonfinite,
    quality_parity,
    runtime_comparison,
    sample_test,
    table_generation,
    test_store,
)

ROOT = pathlib.Path(__file__).resolve().parents[1]
RESULTS = ROOT / "results"
SQP_TOL, QP_TOL = 2e-3, 5e-4

SWEEPS = {m.__name__.rsplit(".", 1)[1]: m for m in (
    experiment_test, sample_test, mppi_temperature, ilqr_tuning, noise_tests,
    new_solver_sweep, ilqr_modern_cells)}


@pytest.fixture
def load_jax_script(monkeypatch):
    """Load a JAX script under a name of its own (``scripts/test.py`` would
    shadow the standard library's ``test``), its ``_common`` found on
    ``scripts/`` and without the persistent compile cache."""
    monkeypatch.setenv("BMPC_COMPILE_CACHE", "")
    monkeypatch.delenv("BMPC_PLATFORM", raising=False)
    monkeypatch.syspath_prepend(str(ROOT / "scripts"))

    def load(name):
        spec = importlib.util.spec_from_file_location(f"jax_script_{name}",
                                                      ROOT / "scripts" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod
    return load


def port_grid(name, argv):
    return list(SWEEPS[name].grid(_common.std_parser("").parse_args(argv)))


@pytest.mark.parametrize("quick", [False, True], ids=["full", "quick"])
@pytest.mark.parametrize("name", sorted(SWEEPS))
def test_grid_matches_the_jax_script(load_jax_script, monkeypatch, tmp_path, name, quick):
    mod = load_jax_script(name)
    calls = []

    def capture(store, params, warmstart=50):
        calls.append((store.dir.name, params, warmstart))

    monkeypatch.setattr(mod, "run_and_store", capture)
    argv = ["--quick"] if quick else []
    monkeypatch.setattr(sys, "argv", [name, *argv, "--no-plots",
                                      "--results-dir", str(tmp_path)])
    mod.main()
    got = port_grid(name, argv)
    assert len(got) == len(calls) > 0
    for i, ((c, p, w), (jc, jp, jw)) in enumerate(zip(got, calls)):
        assert (c, w) == (jc, jw), i
        assert list(p) == list(jp), i
        for key, want in jp.items():
            if key == "start_state":
                np.testing.assert_array_equal(p[key], want)
                assert p[key].dtype == want.dtype
            else:
                assert p[key] == want and type(p[key]) is type(want), (i, key)


def test_full_grids_are_marked_done_in_the_jax_checkpoints():
    """Every full-mode configuration's checkpoint key is one the JAX
    package's sweeps wrote: the format is shared, and a port sweep pointed
    at ``results/`` would skip all of it (so the default is results_torch/)."""
    assert _common.std_parser("").parse_args([]).results_dir == "results_torch"
    total = 0
    for name in SWEEPS:
        for collection, params, warm in port_grid(name, []):
            done = json.loads((RESULTS / collection / "sweep_checkpoint.json").read_text())
            assert _common.config_key(params, warm) in done, (name, params)
            total += 1
    assert total == 4 + 444 + 72 + 36 + 84 + 48 + 18


@pytest.fixture(scope="module")
def quick_runs(tmp_path_factory):
    """Every port sweep once, --quick on the CPU, into one results dir;
    then each a second time."""
    root = tmp_path_factory.mktemp("results_torch")
    argv = ["--quick", "--device", "cpu", "--no-plots", "--results-dir", str(root)]
    again = {}
    for mod in SWEEPS.values():
        mod.main(argv)
    args = _common.std_parser("").parse_args(argv)
    for name in SWEEPS:
        again[name] = _common.run_grid(args, port_grid(name, argv))
    return root, again


def test_quick_sweeps_fill_their_collections_and_resume(quick_runs):
    root, again = quick_runs
    want = {}
    for name in SWEEPS:
        for collection, _, _ in port_grid(name, ["--quick"]):
            want[collection] = want.get(collection, 0) + 1
    assert sorted(p.name for p in root.iterdir()) == sorted(want)
    for collection, n in want.items():
        store = ResultStore(str(root), collection)
        records = store.find()
        assert len(records) == n, collection
        assert len(json.loads((store.dir / "sweep_checkpoint.json").read_text())) == n
        for r in records:
            keys = chip_smoke.experiment_keys(r["sensor_noise"], r["actuation_noise"], False)
            assert sorted(set(r) - {"_id", "date"}) == keys, collection
            assert np.isfinite(r["batch_costs"]).all()
    assert again == {name: [] for name in SWEEPS}  # the second call skipped every one


@pytest.mark.parametrize("name,agent,tol,moves", [("new_solver_sweep", "QPMPC", QP_TOL, True),
                                                  ("experiment_test", "SQP", SQP_TOL, False)])
def test_deterministic_quick_cells_match_jax(quick_runs, name, agent, tol, moves):
    """``moves``: whether the closed loop leaves its start. SQP from zero
    plans at acrobot's resting start has a zero gradient and stays there,
    in both packages (new_solver_sweep gives SQP ``init_std`` for that)."""
    root, _ = quick_runs
    (collection, params, warm), = [
        c for c in port_grid(name, ["--quick"])
        if c[1]["agent"] == agent and "init_std" not in c[1]["agent_config"]]
    (got,) = [r for r in ResultStore(str(root), collection).find({"agent_name": agent})
              if r["agent_config"] == params["agent_config"]]
    want = jexp.Experiment(params).run(warmstart=warm)
    for key in ("env_costs", "env_actions", "env_states"):
        np.testing.assert_allclose(got[key], want[key], rtol=tol, atol=tol, err_msg=key)
    assert (float(np.abs(got["env_actions"]).max()) > 0.01) == moves


def test_quick_sqp_cell_from_injected_plans_matches_jax():
    """new_solver_sweep's quick SQP cell, whose ``init_std`` takes the
    closed loop away from the pendulum's hanging start: from the JAX
    package's initial plans (injected), the port's episodes on the
    configuration's own tier match the JAX package's ``Experiment`` on the
    CPU, to the SQP tolerance."""
    (_, params, warm), = [c for c in port_grid("new_solver_sweep", ["--quick"])
                          if c[1]["agent"] == "SQP"]
    want = jexp.Experiment(params).run(warmstart=warm)
    js, _ = jexp.Experiment(params)._build()
    keys = jax.random.split(jax.random.PRNGKey(params["seed"]), params["repetitions"])
    # run_episode's initial plan: init_state(split(key)[0])
    plans = np.array(jax.vmap(lambda k: js.init_state(jax.random.split(k)[0]).planned_us)(keys))
    exp = texp.Experiment(params, device="cpu")
    solver, noise = exp._build()
    x0s = torch.tensor(np.tile(params["start_state"], (params["repetitions"], 1)),
                       dtype=torch.float32)
    got = run_episodes_fused(exp.env, solver, EpisodeConfig(
        n_steps=params["experiment_length"], warmstart=warm, noise=noise, record_plans=True),
        x0s, use_kernel=False, init_plans=plans, device="cpu")
    for key, field in (("env_costs", "costs"), ("env_actions", "actions"),
                       ("env_states", "observations"),
                       ("agent_planning_actions", "planned_actions")):
        np.testing.assert_allclose(getattr(got, field)[0].numpy(), want[key], rtol=SQP_TOL,
                                   atol=SQP_TOL, err_msg=key)
    assert float(np.abs(want["env_actions"]).max()) > 0.1


def test_sweeps_run_on_the_card_unless_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for mod in SWEEPS.values():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            mod.main(["--quick", "--no-plots", "--results-dir", str(tmp_path)])
    assert not any(tmp_path.iterdir())  # nothing written before the refusal


@pytest.mark.parametrize("mod", [*SWEEPS.values(), purge_nonfinite, table_generation,
                                 runtime_comparison, quality_parity, difftools, test_store],
                         ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_help(mod, capsys):
    with pytest.raises(SystemExit) as exit_:
        mod.main(["--help"])
    assert exit_.value.code == 0
    assert "usage:" in capsys.readouterr().out


def test_table_generation_matches_the_jax_script(load_jax_script, monkeypatch, tmp_path):
    mod = load_jax_script("table_generation")
    monkeypatch.setattr(sys, "argv", ["table_generation", "--results-dir", str(RESULTS),
                                      "--plots-dir", str(tmp_path / "jax")])
    mod.main()
    written = table_generation.main(["--results-dir", str(RESULTS),
                                     "--plots-dir", str(tmp_path / "port")])
    jax_files = sorted((tmp_path / "jax" / "time_comparison").iterdir())
    assert [pathlib.Path(p).name for p in sorted(written)] == [p.name for p in jax_files]
    assert len(jax_files) == 6
    for p in jax_files:
        assert (tmp_path / "port" / "time_comparison" / p.name).read_text() == p.read_text()


def test_quality_parity_matches_the_jax_script(load_jax_script, monkeypatch, tmp_path):
    mod = load_jax_script("quality_parity")
    monkeypatch.chdir(tmp_path)  # the JAX script writes QUALITY.md where it runs
    monkeypatch.setattr(sys, "argv", ["quality_parity", "--results-dir", str(RESULTS)])
    mod.main()
    out = quality_parity.main(["--results-dir", str(RESULTS),
                               "--out", str(tmp_path / "port" / "QUALITY.md")])

    def table_lines(path):
        return [ln for ln in path.read_text().splitlines() if ln.startswith(("|", "**"))]

    want = table_lines(tmp_path / "QUALITY.md")
    assert len(want) > 80
    assert table_lines(out) == want


def test_purge_nonfinite_matches_the_jax_script(load_jax_script, tmp_path, capsys):
    mod = load_jax_script("purge_nonfinite")
    for side in ("jax", "port"):
        shutil.copytree(RESULTS / "experiment_test", tmp_path / side / "experiment_test")
        store = ResultStore(str(tmp_path / side), "experiment_test")
        first = next(store._iter_meta())["_id"]
        with np.load(store.dir / f"{first}.npz") as z:
            arrays = {k: z[k] for k in z.files}
        arrays["env_costs"][3] = np.nan
        np.savez_compressed(store.dir / f"{first}.npz", **arrays)
    assert mod.purge(str(tmp_path / "jax"), "experiment_test") == 1
    assert purge_nonfinite.main([str(tmp_path / "port"), "experiment_test"]) == 1
    assert "checkpoint: 1 entries un-marked" in capsys.readouterr().out
    for name in ("index.jsonl", "sweep_checkpoint.json"):
        assert ((tmp_path / "port" / "experiment_test" / name).read_text()
                == (tmp_path / "jax" / "experiment_test" / name).read_text())
    assert len(list((tmp_path / "port" / "experiment_test").glob("*.npz"))) == 3
    assert purge_nonfinite.main([str(tmp_path / "port"), "experiment_test"]) == 0


def test_store_smoke_and_difftools_run_on_the_cpu(load_jax_script, monkeypatch, tmp_path, capsys):
    test_store.main(["--results-dir", str(tmp_path)])
    assert "store smoke test passed" in capsys.readouterr().out
    difftools.main(["--device", "cpu"])
    port = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["difftools"])
    load_jax_script("difftools").main()
    ref = capsys.readouterr().out
    assert port.count(" OK ") == ref.count(" OK ") == 16
    assert "all derivative checks passed" in port

    def values(text, label):
        return [float(ln.split("=")[1]) for ln in text.splitlines()
                if ln.strip().startswith(label)]

    for label in ("cost ", "final_cost"):
        np.testing.assert_allclose(values(port, label), values(ref, label), rtol=1e-5)


def test_scripts_need_no_pandas_or_matplotlib():
    """The card's machine has neither: the sweeps, the quality check and
    ``aggregate`` import and run without them; the LaTeX tables need pandas
    only when they are written."""
    code = (
        "import sys\n"
        "sys.modules['pandas'] = None\n"
        "sys.modules['matplotlib'] = None\n"
        "import numpy as np\n"
        "from benchmarking_mpc_solvers_tpu_torch.experiment.tables import aggregate\n"
        "from benchmarking_mpc_solvers_tpu_torch.experiment import generate_tables\n"
        "from benchmarking_mpc_solvers_tpu_torch.scripts import (experiment_test, sample_test,\n"
        "    mppi_temperature, ilqr_tuning, noise_tests, new_solver_sweep, ilqr_modern_cells,\n"
        "    quality_parity, purge_nonfinite, table_generation, runtime_comparison)\n"
        "agg = aggregate([{'passed_time': 1.0, 'env_costs': np.array([1.0, 30.0]),\n"
        "                  'batch_costs': np.array([[1.0, 30.0], [2.0, 2.0]])}])\n"
        "assert agg['Median'] == 12.5 and agg['Time'] == 1.0, agg\n"
        "try:\n"
        "    generate_tables([], 'unused')\n"
        "except ImportError:\n"
        "    print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


# The T=10 quality cells where the port's median on the card lay outside the
# JAX package's [Q25, Q75] (PERF.md §5, ROADMAP.md §3): iLQR with
# diag_hessian at ilqr_tuning's configuration on pendulum and acrobot
ILQR_T10 = {"T": 10, "max_iter": 5, "threshold": 1e-7, "closed_loop": False,
            "diag_hessian": True}


@pytest.mark.parametrize("name", ["pendulum", "acrobot"])
def test_ilqr_quality_miss_cells_against_jax(name):
    """From the JAX package's initial plans (injected), the port's closed
    loop at the cell's configuration matches the JAX package's on the CPU
    (warm start 5, 5 steps, the tolerance of tests/test_torch_ilqr.py); at
    the study's full depth the JAX package's own closed loop on the CPU lies
    outside its study runs' [Q25, Q75] as well. What moves the card's runs
    outside at full depth is not shown here."""
    jenv, tenv = JENVS[name], TENVS[name]
    js = JILQR(model=jenv.model, **ILQR_T10)
    B = 2
    keys = jax.random.split(jax.random.PRNGKey(2), B)
    x0s = np.tile(np.asarray(jenv.start_state), (B, 1)).astype(np.float32)
    want = j_batch(jenv, js, JConfig(n_steps=5, warmstart=5), keys, jnp.asarray(x0s))
    # run_episode's initial plan: init_state(split(key)[0])
    plans = np.array(jax.vmap(lambda k: js.init_state(jax.random.split(k)[0]).planned_us)(keys))
    got = run_episodes_fused(tenv, TILQR(model=tenv.model, **ILQR_T10),
                             EpisodeConfig(n_steps=5, warmstart=5), torch.tensor(x0s),
                             init_plans=plans, use_kernel=False, device="cpu")
    for field in ("costs", "actions", "observations", "warmstart_trajectories"):
        np.testing.assert_allclose(getattr(got, field).numpy(), np.asarray(getattr(want, field)),
                                   rtol=2e-3, atol=2e-3, err_msg=field)

    study = [r for r in jexp.ResultStore(str(RESULTS), "ilqr_runs2").find(
        {"env_name": _common.ENV_NAMES[name], "agent_config.T": 10}) if not r["sensor_noise"]]
    assert len(study) == 9  # max_iter 5, 10, 25, three runs each
    agg = jexp.aggregate(study)
    full = j_batch(jenv, js, JConfig(n_steps=100, warmstart=50), keys[:1], jnp.asarray(x0s[:1]))
    total = float(np.clip(np.asarray(full.costs), -20, 20).sum())
    assert not agg["Q 25"] <= total <= agg["Q 75"], (total, agg)


def test_episode_counts_keep_non_finite_runs():
    results = [{"batch_costs": np.array([[1.0, 2.0], [np.nan, 1.0]])},
               {"batch_costs": np.array([[np.inf, 0.0]])}]
    assert _common.episode_counts(results) == (3, 2)


def test_study_quality_compare_holds_a_store_against_itself(tmp_path, capsys):
    """The quality check's subset is the study's 42 T=10 configurations,
    and with the JAX package's runs on both sides every cell lies inside,
    at a ratio of one."""
    import study_quality

    args = _common.std_parser("").parse_args(["--results-dir", str(RESULTS)])
    assert len(list(study_quality.configs(args))) == 3 * (6 + 3 + 5)
    out = study_quality.main(["compare", "--results-dir", str(RESULTS),
                              "--json", str(tmp_path / "q.json")])
    assert json.loads((tmp_path / "q.json").read_text()) == out
    assert len(out["cells"]) == 9
    for row in out["cells"]:
        assert row["inside"] and row["ratio"] == 1.0, row
        assert row["port"]["non_finite"] == 0, row
    assert "| pendulum | ILQR |" in capsys.readouterr().out
