"""A configuration, a traffic mix, a check and a metric dropped into their
folders, with their entries in BENCHMARK.json, run without an edit to any
file of the harness."""

import json
import shutil

from portbench.run import cell_spec, run_cell

from .helpers import ROOT


def test_new_files_are_found_without_an_edit(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    here = tmp_path / "portbench"
    config = json.loads((here / "configs" / "cartpole-mppi-k64.json").read_text())
    config.update(name="cartpole-mppi-k8", n_steps=3,
                  solver_args=dict(config["solver_args"], K=8, T=10))
    (here / "configs" / "cartpole-mppi-k8.json").write_text(json.dumps(config))
    (here / "traffic" / "tiny-noise.json").write_text(json.dumps(
        {"batch": 8, "x0_jitter": 0.001, "sensor_std": 0.05, "model_noise_std": 0.05}))
    (here / "checks" / "new-cell.json").write_text(json.dumps(
        {"sample_batches": 1, "sample_scenarios": 4,
         "limits": {"first_action_gap": 1e-6, "departed_pct": 0.0, "plant_gap": 0.0}}))
    (here / "metrics" / "last_batch_ms.py").write_text(
        "def read(ctx):\n    return ctx.batch_times[-1] * 1e3\n")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "cartpole-mppi-k8", "source": "a test",
                             "file": "portbench/configs/cartpole-mppi-k8.json", "reduced": ["K"],
                             "why": "a test"})
    bench["workloads"].append({"name": "new-cell", "config": "cartpole-mppi-k8",
                               "traffic": "tiny-noise", "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "last_batch_ms", "unit": "ms", "better": "lower",
                                "bound": 0.25, "source": "host_clock", "workloads": ["new-cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    spec = cell_spec("new-cell", tmp_path)
    assert spec["traffic"]["sensor_std"] == 0.05 and spec["config"]["solver_args"]["K"] == 8
    out = run_cell(spec, 3, 0.3, False, device="cpu")
    assert out["correct"], out["checks"]
    assert {"solves_per_s", "setup_s", "last_batch_ms"} == set(out["metrics"])
    # the metric lists its cell: the benchmark's own cells do not report it
    assert "last_batch_ms" not in {m["name"] for m in cell_spec("mppi-k64-clean", tmp_path)
                                   ["end_to_end"]}
