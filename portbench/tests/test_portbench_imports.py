"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program."""

import ast
import subprocess
import sys
from pathlib import Path

from portbench.run import forbidden_modules

from .helpers import ROOT

PKG = ROOT / "portbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "benchmarking_mpc_solvers_tpu"}


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_no_source_imports_jax_or_the_jax_package():
    for path in PKG.rglob("*.py"):
        assert not top_level_imports(path) & FORBIDDEN, path


def test_reference_imports_nothing_of_the_program():
    for path in (PKG / "reference").rglob("*.py"):
        assert top_level_imports(path) <= {"__future__", "math", "typing", "numpy", "torch"}, path


def test_names_are_compared_whole():
    loaded = ["jax.numpy", "jaxlib", "jaxtyping", "flax.linen", "benchmarking_mpc_solvers_tpu",
              "benchmarking_mpc_solvers_tpu.ops", "benchmarking_mpc_solvers_tpu_torch",
              "benchmarking_mpc_solvers_tpu_torch.ops.fused", "portbench.run"]
    assert forbidden_modules(loaded) == ["benchmarking_mpc_solvers_tpu",
                                         "benchmarking_mpc_solvers_tpu.ops", "flax.linen",
                                         "jax.numpy", "jaxlib"]


def test_a_run_loads_no_jax():
    code = ("import sys; import portbench.run, portbench.control, portbench.trace; "
            "from portbench.workload import Workload; "
            "from portbench.tests.helpers import tiny_spec; "
            "s = tiny_spec('mppi-k64-sensor-noise'); Workload(s['config'], s['traffic'], 'cpu'); "
            "print(portbench.run.forbidden_modules(sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
