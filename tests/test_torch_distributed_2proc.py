"""Two-process ``torch.distributed`` job of the port on the CPU.

Two OS processes of the port alone (no JAX) join one ``gloo`` group through
``distributed_init`` (on localhost, a free port) and compute
``global_stats`` of a batch split between them: its all-reduces must cross
the process boundary to give the statistics of the whole batch. The pattern
of tests/test_distributed_2proc.py. Each process has a hard timeout, so a
rendezvous that hangs fails the test instead of holding the run.
"""

import json
import os
import pathlib
import socket
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
TIMEOUT_S = 60

WORKER = r"""
import json, sys
import torch
import torch.distributed as dist
from benchmarking_mpc_solvers_tpu_torch.parallel import (
    distributed_init, global_mesh, global_stats,
)

port, rank = sys.argv[1], int(sys.argv[2])
ok = distributed_init(coordinator_address=f"localhost:{port}", num_processes=2,
                      process_id=rank, device="cpu")
assert ok, "distributed_init returned False in a 2-process job"
assert dist.get_world_size() == 2 and dist.get_rank() == rank
mesh = global_mesh(device="cpu")
assert mesh.shape == {"batch": 2}
data = torch.arange(8, dtype=torch.float32)
mean, vmin, vmax = global_stats(data[4 * rank:4 * (rank + 1)], mesh)
print(json.dumps({"rank": rank, "mean": float(mean), "min": float(vmin),
                  "max": float(vmax)}))
dist.destroy_process_group()
assert "jax" not in sys.modules
"""


def test_two_process_global_stats():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(port), str(i)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env,
                              text=True, cwd=ROOT)
             for i in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=TIMEOUT_S)
            assert p.returncode == 0, f"worker failed:\n{err[-3000:]}"
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for res in outs:
        # the statistics of arange(8): only if the all-reduces crossed the
        # process boundary (each process holds half the rows)
        assert res["mean"] == pytest.approx(3.5)
        assert res["min"] == 0.0 and res["max"] == 7.0
