"""Closed-loop episodes, the ``Experiment`` runner, the result store, and
the tables and plots of results.

``tables`` needs pandas and ``plot`` matplotlib; both are imported only when
one of their names is first used, so that the rest of the package runs
where neither is installed.
"""

import importlib

from .episode import (  # noqa: F401
    EpisodeConfig,
    EpisodeResult,
    run_episode,
    run_episodes_batch,
    run_episodes_fused,
)
from .experiment import SOLVER_REGISTRY, Experiment, make_solver  # noqa: F401
from .store import ResultStore, decode_result, encode_result  # noqa: F401

_LAZY = {
    "plot_cost_bands": "plot",
    "plot_experiment": "plot",
    "plot_experiments": "plot",
    "plot_ilqr_line_search": "plot",
    "aggregate": "tables",
    "format_table": "tables",
    "generate_tables": "tables",
    "write_latex_table": "tables",
}


def __getattr__(name):
    if name in _LAZY:
        return getattr(importlib.import_module(f".{_LAZY[name]}", __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
