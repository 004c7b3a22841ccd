"""The port's figure scripts against the JAX package's, on the CPU:
``per_config_plots`` (the same figure layout from the same store) and
``test`` (the same artifacts). The JAX scripts are loaded by file path
(``scripts/test.py`` would shadow the standard library's ``test``), with
their ``_common`` found on ``scripts/``.
"""

import csv
import importlib.util
import pathlib
import sys

import pytest

from benchmarking_mpc_solvers_tpu_torch.experiment import ResultStore
from benchmarking_mpc_solvers_tpu_torch.scripts import per_config_plots
from benchmarking_mpc_solvers_tpu_torch.scripts import test as port_test

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture
def jax_script(monkeypatch):
    monkeypatch.setenv("BMPC_COMPILE_CACHE", "")
    monkeypatch.delenv("BMPC_PLATFORM", raising=False)
    monkeypatch.syspath_prepend(str(ROOT / "scripts"))

    def run(name, argv):
        spec = importlib.util.spec_from_file_location(f"jax_script_{name}",
                                                      ROOT / "scripts" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
        return mod.main()
    return run


def _files(root: pathlib.Path) -> list:
    return sorted(str(p.relative_to(root)) for p in root.rglob("*") if p.is_file())


def test_per_config_plots_draws_the_jax_layout(jax_script, tmp_path):
    """The quick grid's temperature runs of the JAX study (results/, read
    only) copied into a store of their own: both scripts draw the same
    figures under the same names."""
    src = ResultStore(str(ROOT / "results"), "temperature_exp")
    store = ResultStore(str(tmp_path / "results"), "temperature_exp")
    for r in src.find({"agent_config.T": 5, "agent_config.lam": 0.1}):
        store.insert({k: v for k, v in r.items() if k not in ("_id", "date")})
    args = ["--quick", "--results-dir", str(tmp_path / "results")]
    n = per_config_plots.main([*args, "--plots-dir", str(tmp_path / "port")])
    jax_script("per_config_plots", [*args, "--plots-dir", str(tmp_path / "jax")])
    assert n == len(_files(tmp_path / "port")) > 0
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")


def test_manual_comparison_writes_the_jax_artifacts(jax_script, tmp_path, monkeypatch):
    out = port_test.main(["--quick", "--device", "cpu", "--out", str(tmp_path / "port")])
    monkeypatch.chdir(tmp_path)
    jax_script("test", ["--quick"])
    (jax_out,) = (tmp_path / "experiments").iterdir()
    assert _files(out) == _files(jax_out)
    for name in _files(out):
        if name.endswith(".csv"):
            rows = [list(csv.reader(open(d / name))) for d in (out, jax_out)]
            assert rows[0][0] == rows[1][0] and len(rows[0]) == len(rows[1]) == 9, name
