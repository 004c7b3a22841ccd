"""Structured run logging and metrics.

Counterpart of ``benchmarking_mpc_solvers_tpu/utils/logging.py``: a
lightweight metrics logger with step-scoped scalar series, jsonl persistence
and quiet/verbose console mirroring, for host-side code. A 0-d tensor is
logged as a float.
"""

from __future__ import annotations

import json
import pathlib
import time
from typing import Any, Dict, Optional

import torch


def _scalar(v: Any) -> Any:
    return float(v) if torch.is_tensor(v) and v.ndim == 0 else v


class RunLogger:
    def __init__(self, path: Optional[str] = None, verbose: bool = True, name: str = "run"):
        self.name = name
        self.verbose = verbose
        self.path = pathlib.Path(path) if path else None
        if self.path:
            self.path.parent.mkdir(parents=True, exist_ok=True)
        self._series: Dict[str, list] = {}
        self._t0 = time.time()

    def log(self, step: int, **scalars: Any) -> None:
        scalars = {k: _scalar(v) for k, v in scalars.items()}
        rec = {"step": step, "t": round(time.time() - self._t0, 3), **scalars}
        for k, v in scalars.items():
            self._series.setdefault(k, []).append((step, v))
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(rec, default=float) + "\n")
        if self.verbose:
            body = " ".join(f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                            for k, v in scalars.items())
            print(f"[{self.name} step {step}] {body}")

    def series(self, key: str):
        return list(self._series.get(key, []))

    def summary(self) -> Dict[str, float]:
        out = {}
        for k, pairs in self._series.items():
            vals = [v for _, v in pairs if isinstance(v, (int, float))]
            if vals:
                out[f"{k}_last"] = float(vals[-1])
                out[f"{k}_mean"] = float(sum(vals) / len(vals))
        return out
