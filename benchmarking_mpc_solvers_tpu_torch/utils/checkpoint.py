"""Checkpoint / resume for long sweeps and episodes.

Counterpart of ``benchmarking_mpc_solvers_tpu/utils/checkpoint.py``, with its
on-disk format: a pytree of arrays goes to one ``.npz`` holding ``leaf_i``
entries plus a ``.json`` sidecar with ``treedef``, ``n_leaves`` and
``meta``, so either package reads what the other writes.

The leaves are numbered in JAX's flattening order, which this module keeps
with its own small flatten: dicts in sorted key order, lists and tuples in
order, NamedTuples field by field, ``None`` as no leaf, and anything else
(a tensor, an array, a number) as one leaf. ``torch.utils._pytree`` keeps
dicts in insertion order and would number the leaves differently.
"""

from __future__ import annotations

import json
import pathlib
from typing import Any, List, Optional

import numpy as np
import torch

from ..device import to_numpy


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(type(x), "_fields")


def _flatten(tree, leaves: List[Any]) -> str:
    """Appends the leaves of ``tree`` in JAX's order; returns the structure
    as JAX prints a treedef's body."""
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_flatten(tree[k], leaves)}"
                               for k in sorted(tree)) + "}"
    if _is_namedtuple(tree):
        body = ", ".join(_flatten(v, leaves) for v in tree)
        return f"CustomNode(namedtuple[{type(tree).__name__}], [{body}])"
    if isinstance(tree, (list, tuple)):
        body = ", ".join(_flatten(v, leaves) for v in tree)
        if isinstance(tree, list):
            return f"[{body}]"
        return f"({body},)" if len(tree) == 1 else f"({body})"
    leaves.append(tree)
    return "*"


def flatten(tree):
    """(leaves in JAX's order, the treedef string JAX would write)."""
    leaves: List[Any] = []
    body = _flatten(tree, leaves)
    return leaves, f"PyTreeDef({body})"


def _unflatten(like, leaves):
    if like is None:
        return None
    if isinstance(like, dict):
        filled = {k: _unflatten(like[k], leaves) for k in sorted(like)}
        return {k: filled[k] for k in like}
    if _is_namedtuple(like):
        return type(like)(*(_unflatten(v, leaves) for v in like))
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, leaves) for v in like)
    arr = next(leaves)
    if torch.is_tensor(like):
        return torch.from_numpy(np.array(arr)).to(like.device)
    return arr


def save_pytree(path: str, tree: Any, meta: Optional[dict] = None) -> None:
    """Save a pytree of tensors or arrays (+ JSON-able metadata)."""
    leaves, treedef = flatten(tree)
    p = pathlib.Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(
        p.with_suffix(".npz"),
        **{f"leaf_{i}": to_numpy(leaf) for i, leaf in enumerate(leaves)},
    )
    p.with_suffix(".json").write_text(
        json.dumps({"treedef": treedef, "n_leaves": len(leaves), "meta": meta or {}})
    )


def load_pytree(path: str, like: Any) -> Any:
    """Load into the structure of ``like`` (the treedef string is a
    fingerprint only). A leaf whose counterpart in ``like`` is a tensor
    comes back as a tensor on that tensor's device; other leaves as numpy
    arrays, as the reference returns them."""
    p = pathlib.Path(path)
    info = json.loads(p.with_suffix(".json").read_text())
    leaves_like, _ = flatten(like)
    if info["n_leaves"] != len(leaves_like):
        raise ValueError(
            f"checkpoint has {info['n_leaves']} leaves, expected {len(leaves_like)}"
        )
    with np.load(p.with_suffix(".npz")) as z:
        leaves = [z[f"leaf_{i}"] for i in range(info["n_leaves"])]
    return _unflatten(like, iter(leaves))


def load_meta(path: str) -> dict:
    return json.loads(pathlib.Path(path).with_suffix(".json").read_text())["meta"]


class SweepCheckpoint:
    """Resume marker for sweep scripts: records completed config keys."""

    def __init__(self, path: str):
        self.path = pathlib.Path(path)
        self.done: set = set()
        if self.path.exists():
            self.done = set(json.loads(self.path.read_text()))

    def is_done(self, key: str) -> bool:
        return key in self.done

    def mark(self, key: str) -> None:
        self.done.add(key)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.path.write_text(json.dumps(sorted(self.done)))
