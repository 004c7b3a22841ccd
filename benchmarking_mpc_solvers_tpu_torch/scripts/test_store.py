"""Result-store smoke test.

Counterpart of ``scripts/test_store.py``: inserts a result dict with
ndarray payloads into a ``ResultStore``, finds it back through a
pymongo-style dotted query, and checks that the arrays come back bit for
bit.

Usage: python -m benchmarking_mpc_solvers_tpu_torch.scripts.test_store [--results-dir DIR]
"""

from __future__ import annotations

import argparse
import tempfile

import numpy as np

from ..experiment import ResultStore


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--results-dir", default=None)
    args = ap.parse_args(argv)

    root = args.results_dir or tempfile.mkdtemp(prefix="bmpc_store_smoke_")
    store = ResultStore(root, collection="smoke")

    costs = np.arange(12, dtype=np.float32).reshape(3, 4)
    doc_id = store.insert(
        {
            "name": "store-smoke",
            "agent_config": {"K": 7, "T": 5, "lam": 0.1},
            "env_costs": costs,
        }
    )
    print(f"inserted {doc_id} into {root}/smoke")

    hits = store.find({"agent_config.K": 7, "name": "store-smoke"})
    if not hits:
        raise SystemExit("dotted-path query found nothing")
    got = hits[-1]["env_costs"]
    if not (got.dtype == costs.dtype and got.tobytes() == costs.tobytes()):
        raise SystemExit("array roundtrip mismatch")
    if store.count({"agent_config.K": 7}) < 1:
        raise SystemExit("count found nothing")

    print(f"found {len(hits)} doc(s); array roundtrip exact; count OK")
    print("store smoke test passed")


if __name__ == "__main__":
    main()
