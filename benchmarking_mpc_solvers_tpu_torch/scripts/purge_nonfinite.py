"""Purge the non-finite runs of result collections and un-mark them in the
sweep checkpoint, so that the sweep script runs them again.

Counterpart of ``scripts/purge_nonfinite.py``:

    python -m benchmarking_mpc_solvers_tpu_torch.scripts.purge_nonfinite [ROOT [COLLECTION ...]]

ROOT defaults to ``results_torch``; the collections to the five study
sweeps'. Each purged run is printed: a study's median is taken after the
purge, so count what went before quoting one.
"""

import argparse
import json
import os

import numpy as np

from ..experiment import ResultStore

ENV_KEYS = {"PendulumEnvironment": "pendulum",
            "CartpoleSwingupEnvironment": "cartpole_swingup",
            "AcrobotEnvironment": "acrobot"}


def _matches(cfg: dict, meta: dict) -> bool:
    """Exact configuration match of a checkpoint entry and a result: agent,
    env, agent_config and the noise stds (the result stores them as
    *_noise_std, the entry the raw floats). A broader match would run
    finished configurations again and duplicate their rows."""
    if cfg.get("agent") != meta["agent_name"]:
        return False
    if cfg.get("env") != ENV_KEYS.get(meta["env_name"]):
        return False
    if cfg.get("agent_config") != meta.get("agent_config"):
        return False
    act = float(cfg.get("actuation_noise", 0) or 0)
    sens = float(cfg.get("sensor_noise", 0) or 0)
    return (act == float(meta.get("actuation_noise_std", 0) or 0)
            and sens == float(meta.get("sensor_noise_std", 0) or 0))


def purge(root: str, collection: str) -> int:
    store = ResultStore(root, collection)
    bad_meta = []
    keep_lines = []
    for meta in store._iter_meta():
        npz = store.dir / f"{meta['_id']}.npz"
        if not npz.exists():
            # an index entry whose payload is gone (a partial copy, a crashed
            # insert): drop the dangling line
            print(f"warning: {npz.name} missing, dropping index entry")
            bad_meta.append(meta)
            continue
        with np.load(npz, allow_pickle=False) as z:
            finite = all(np.isfinite(z[k]).all() for k in z.files)
        if finite:
            keep_lines.append(json.dumps(meta, default=str))
        else:
            bad_meta.append(meta)
    if not bad_meta:
        print(f"{collection}: all runs finite")
        return 0
    for meta in bad_meta:
        npz = store.dir / f"{meta['_id']}.npz"
        if npz.exists():
            npz.unlink()
        print(f"purged {meta['agent_name']} on {meta['env_name']} "
              f"(sensor={meta.get('sensor_noise')}, "
              f"act={meta.get('actuation_noise')})")
    # the index is rewritten whole and moved into place: a crash mid-write
    # must not lose the collection
    tmp = store.index_path.with_suffix(".jsonl.tmp")
    tmp.write_text("\n".join(keep_lines) + "\n")
    os.replace(tmp, store.index_path)

    ckpt_path = store.dir / "sweep_checkpoint.json"
    if ckpt_path.exists():
        entries = json.loads(ckpt_path.read_text())
        kept = [e for e in entries
                if not any(_matches(json.loads(e), m) for m in bad_meta)]
        ckpt_tmp = ckpt_path.with_suffix(".json.tmp")
        ckpt_tmp.write_text(json.dumps(kept))
        os.replace(ckpt_tmp, ckpt_path)
        print(f"checkpoint: {len(entries) - len(kept)} entries un-marked")
    return len(bad_meta)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("root", nargs="?", default="results_torch")
    ap.add_argument("collections", nargs="*",
                    default=["noise_test", "cem_ratios", "mppi_samples",
                             "temperature_exp", "ilqr_runs2"])
    args = ap.parse_args(argv)
    total = sum(purge(args.root, c) for c in args.collections)
    print(f"total purged: {total}")
    return total


if __name__ == "__main__":
    main()
