"""Multi-process initialization and cross-process statistics.

Counterpart of ``benchmarking_mpc_solvers_tpu/parallel/distributed.py``,
with ``torch.distributed`` in place of ``jax.distributed``: one process per
device, the scenario batch split over the processes, and global reductions
(sweep statistics) through ``all_reduce``. The backend follows the device:
``gloo`` for the CPU, ``nccl`` for CUDA. A single-process job uses these
helpers without branches: ``distributed_init`` returns False and
``global_stats`` reduces the local values.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device
from .mesh import BATCH_AXIS, Mesh


def _world() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def distributed_init(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device="cuda",
) -> bool:
    """Join the process group of a multi-process job.

    ``coordinator_address`` ("host:port") with ``num_processes`` and
    ``process_id``, or, without them, the environment (``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``). Returns False, doing
    nothing, for a single-process job, so local paths need no branches; and
    whether the job has more than one process when the group cannot be
    joined (already joined, or no job in the environment)."""
    if num_processes is not None and num_processes <= 1:
        return False
    backend = "nccl" if resolve_device(device).type == "cuda" else "gloo"
    if dist.is_initialized():
        return _world() > 1
    init = "env://" if coordinator_address is None else (
        coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}")
    try:
        dist.init_process_group(
            backend, init_method=init,
            world_size=-1 if num_processes is None else num_processes,
            rank=-1 if process_id is None else process_id)
        return True
    except (ValueError, RuntimeError):
        # no multi-process job in the environment
        return _world() > 1


def global_mesh(axis: str = BATCH_AXIS, device="cuda") -> Mesh:
    """A 1-D mesh with one device per process of the job: process r's is
    ``cuda:(r mod the local device count)``, or the CPU."""
    d = resolve_device(device)
    world = _world()
    if d.type == "cuda":
        count = torch.cuda.device_count()
        devs = [torch.device("cuda", r % count) for r in range(world)]
    else:
        devs = [d] * world
    arr = np.empty(world, dtype=object)
    arr[:] = devs
    return Mesh(arr, (axis,))


def global_stats(values, mesh: Mesh, axis: str = BATCH_AXIS):
    """(mean, min, max) of the per-scenario scalars that every process
    holds: ``values`` this process's (B_local,) tensor, or its list of
    shards (``shard_batch``). The sums of the values and of their count
    are all-reduced with SUM, the extremes with MIN and MAX, over the job's
    processes; each process gets the same three 0-d tensors."""
    if axis not in mesh.axis_names:
        raise ValueError(f"axis {axis!r} is not an axis of the mesh {mesh.axis_names}")
    if not torch.is_tensor(values):
        home = values[0].device
        values = torch.cat([v.to(home) for v in values])
    values = values.to(torch.float32)
    total = torch.stack([values.sum(), torch.tensor(float(values.shape[0]),
                                                    device=values.device)])
    vmin, vmax = values.min(), values.max()
    if _world() > 1:
        dist.all_reduce(total, op=dist.ReduceOp.SUM)
        dist.all_reduce(vmin, op=dist.ReduceOp.MIN)
        dist.all_reduce(vmax, op=dist.ReduceOp.MAX)
    return total[0] / total[1], vmin, vmax
