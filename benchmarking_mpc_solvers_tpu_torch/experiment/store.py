"""Result persistence with query-by-config.

Counterpart of ``benchmarking_mpc_solvers_tpu/experiment/store.py``, in the
same on-disk format, so that a store written by either package is read by
the other: each result's arrays go to one ``.npz`` (``np.savez_compressed``)
and its JSON-able metadata, with ``_id`` and ``date``, to one line of an
append-only ``index.jsonl``. ``find`` takes the reference's dotted-path
queries (``{"agent_config.T": 50}``) with pymongo-style ``$in``, ``$gt``,
``$lt`` and ``$ne``. numpy only: a ``torch.Tensor`` in a result is stored as
its numpy array.
"""

from __future__ import annotations

import datetime
import json
import pathlib
import uuid
from typing import Any, Dict, Iterable, List, Optional

import numpy as np
import torch


def encode_result(result: Dict[str, Any]):
    """Split a result dict into (JSON-able metadata, arrays); a tensor
    becomes a numpy array on the host."""
    meta, arrays = {}, {}
    for k, v in result.items():
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().numpy()
        if isinstance(v, np.ndarray):
            arrays[k] = v
        elif isinstance(v, np.generic):
            meta[k] = v.item()
        else:
            meta[k] = v
    meta["date"] = datetime.datetime.now().isoformat()
    return meta, arrays


def decode_result(meta: Dict[str, Any], npz) -> Dict[str, Any]:
    out = dict(meta)
    for k in npz.files:
        out[k] = npz[k]
    return out


def _get_path(d: Dict[str, Any], dotted: str):
    cur: Any = d
    for part in dotted.split("."):
        if not isinstance(cur, dict) or part not in cur:
            return None
        cur = cur[part]
    return cur


def _match(meta: Dict[str, Any], query: Dict[str, Any]) -> bool:
    for path, want in query.items():
        got = _get_path(meta, path)
        if isinstance(want, dict):  # operators
            for op, val in want.items():
                if op == "$in" and got not in val:
                    return False
                if op == "$gt" and not (got is not None and got > val):
                    return False
                if op == "$lt" and not (got is not None and got < val):
                    return False
                if op == "$ne" and got == val:
                    return False
        elif got != want:
            return False
    return True


class ResultStore:
    """A named collection of experiment results on disk."""

    def __init__(self, root: str, collection: str = "default"):
        self.dir = pathlib.Path(root) / collection
        self.dir.mkdir(parents=True, exist_ok=True)
        self.index_path = self.dir / "index.jsonl"

    def insert(self, result: Dict[str, Any]) -> str:
        meta, arrays = encode_result(result)
        rid = uuid.uuid4().hex[:16]
        meta["_id"] = rid
        np.savez_compressed(self.dir / f"{rid}.npz", **arrays)
        with open(self.index_path, "a") as f:
            f.write(json.dumps(meta, default=str) + "\n")
        return rid

    def _iter_meta(self) -> Iterable[Dict[str, Any]]:
        if not self.index_path.exists():
            return
        with open(self.index_path) as f:
            for line in f:
                line = line.strip()
                if line:
                    yield json.loads(line)

    def find(self, query: Optional[Dict[str, Any]] = None,
             arrays: bool = True) -> List[Dict[str, Any]]:
        """pymongo-style find: dotted-path equality / $in / $gt / $lt / $ne."""
        out = []
        for meta in self._iter_meta():
            if query and not _match(meta, query):
                continue
            if arrays:
                with np.load(self.dir / f"{meta['_id']}.npz", allow_pickle=False) as z:
                    out.append(decode_result(meta, z))
            else:
                out.append(dict(meta))
        return out

    def count(self, query: Optional[Dict[str, Any]] = None) -> int:
        return len(self.find(query, arrays=False))
