"""Device meshes and sharded scenario batching.

Counterpart of ``benchmarking_mpc_solvers_tpu/parallel/mesh.py``. The axis
that spans devices is the scenario batch: per-scenario programs need no
communication, so each device runs its contiguous tile of scenarios on its
own and the results are gathered in scenario order.

JAX's mesh is one process over many devices, and ``shard_map`` runs a
function on each. PyTorch has neither, so a ``Mesh`` here is an array of
``torch.device``s of the mesh's shape plus its axis names, and a sharded
function is a loop that launches every shard's work on its device before it
gathers any result, so that the devices overlap. ``make_mesh(n,
device_type="cpu")`` repeats the CPU device n times, which lets one process
run the sharded paths on the CPU at the reference tests' mesh sizes.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device

BATCH_AXIS = "batch"
SAMPLE_AXIS = "sample"


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    devices: np.ndarray  # object array of torch.device, the mesh's shape
    axis_names: tuple

    @property
    def shape(self) -> dict:
        """Axis name -> size, as JAX's ``Mesh.shape``."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    def axis_devices(self, axis: str) -> list:
        """One device per index along ``axis`` (the first along the other
        axes): where that shard of a batch sharded over ``axis`` lives."""
        devs = np.moveaxis(self.devices, self.axis_names.index(axis), 0)
        return [d.flat[0] if isinstance(d, np.ndarray) else d for d in devs]


def make_mesh(
    n_devices: Optional[int] = None,
    axes: Sequence[str] = (BATCH_AXIS,),
    shape: Optional[Sequence[int]] = None,
    device_type: str = "cuda",
) -> Mesh:
    """A mesh over the first n devices of ``device_type`` (default: every
    CUDA device, a 1-D scenario-batch mesh). ``device_type="cpu"`` repeats
    the CPU device n times (default 1)."""
    if device_type == "cpu":
        devs = [torch.device("cpu")] * (1 if n_devices is None else n_devices)
    else:
        resolve_device(device_type)
        count = torch.cuda.device_count()
        n = count if n_devices is None else n_devices
        if n > count:
            raise ValueError(f"make_mesh: {n} devices asked for, {count} present")
        devs = [torch.device(device_type, i) for i in range(n)]
    n = len(devs)
    if shape is None:
        shape = (n,) if len(axes) == 1 else None
    if shape is None:
        raise ValueError("shape required for multi-axis meshes")
    arr = np.empty(n, dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(tuple(shape)), tuple(axes))


def _on(device: torch.device):
    """Make ``device`` the current CUDA device for the block (no-op on the
    CPU)."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def _split(x, n: int, name: str) -> list:
    if x.shape[0] % n:
        raise ValueError(f"{name}: a leading axis of {x.shape[0]} does not split over "
                         f"{n} shards")
    return list(torch.chunk(x, n))


def shard_batch(mesh: Mesh, tree, axis: str = BATCH_AXIS) -> list:
    """Split the leading axis of every tensor in ``tree`` (a tensor, or a
    tuple or list of them) into contiguous chunks, one per device along
    ``axis``, each on its device. Returns the list of per-shard trees."""
    devs = mesh.axis_devices(axis)
    if torch.is_tensor(tree):
        return [c.to(d) for c, d in zip(_split(tree, len(devs), "shard_batch"), devs)]
    parts = [shard_batch(mesh, t, axis) for t in tree]
    return [type(tree)(p[i] for p in parts) for i in range(len(devs))]


def _shards(mesh: Mesh, x0s, axis: str) -> list:
    """Per-shard (B/n, S) states: ``x0s`` whole, or as ``shard_batch`` gave
    them."""
    if torch.is_tensor(x0s) or isinstance(x0s, np.ndarray):
        return shard_batch(mesh, torch.as_tensor(x0s, dtype=torch.float32), axis)
    devs = mesh.axis_devices(axis)
    if len(x0s) != len(devs):
        raise ValueError(f"{len(x0s)} shards given for {len(devs)} devices")
    return [torch.as_tensor(x, dtype=torch.float32).to(d) for x, d in zip(x0s, devs)]


def _generators(devs: list, generators) -> list:
    """The caller's per-shard generators, or shard i's seeded with i."""
    if generators is None:
        return [torch.Generator(device=d).manual_seed(i) for i, d in enumerate(devs)]
    if len(generators) != len(devs):
        raise ValueError(f"{len(generators)} generators given for {len(devs)} shards")
    return list(generators)


def _gather(results: list, device: torch.device):
    """EpisodeResults of the shards -> one, batch concatenated in shard
    order on ``device``."""
    fields = zip(*results)
    return type(results[0])(*(None if f[0] is None else torch.cat([t.to(device) for t in f])
                              for f in fields))


def sharded_episodes(env, solver, cfg, mesh: Mesh, axis: str = BATCH_AXIS):
    """Return ``fn(x0s, generators=None) -> EpisodeResult`` with the
    scenario batch sharded over ``mesh``: each device runs its shard
    through ``run_episodes_batch`` (the plain batched tier) with its own
    generator (``generators``, one per shard on its device; default: shard
    i's seeded with i). The result's batch is in scenario order on the
    mesh's first device."""
    from ..experiment.episode import run_episodes_batch

    devs = mesh.axis_devices(axis)

    def fn(x0s, generators=None):
        shards = _shards(mesh, x0s, axis)
        gens = _generators(devs, generators)
        results = []
        for x, g, d in zip(shards, gens, devs):
            with _on(d):
                results.append(run_episodes_batch(env, solver, cfg, x, generator=g, device=d))
        return _gather(results, devs[0])

    return fn


def sharded_episodes_kernel(env, solver, cfg, mesh: Mesh, axis: str = BATCH_AXIS):
    """Single-kernel episode tier sharded over the mesh: return
    ``fn(x0s, generators=None, seeds=None) -> EpisodeResult``, where each
    device runs its tile of scenarios through ``_run_episodes_kernel``
    (kernel 1 for MPPI, kernel 3 for CEM), with no communication between
    devices. Each shard draws its own per-call seeds from its generator, as
    the reference's shards draw theirs from their local keys, so shards have
    distinct noise streams; ``seeds`` (n_shards, n_calls) replaces the
    draws. Every shard's episode is launched before any is gathered.

    Requires a solver whose ``kernel_ok()`` holds, and a batch that splits
    evenly over the shards, as the reference's ``shard_map`` does."""
    from ..experiment.episode import _run_episodes_kernel

    if not (getattr(solver, "kernel_ok", None) and solver.kernel_ok()):
        raise ValueError("sharded_episodes_kernel needs a solver with the kernel tier "
                         "(kernel_ok()); use sharded_episodes")
    devs = mesh.axis_devices(axis)

    def fn(x0s, generators=None, seeds=None):
        shards = _shards(mesh, x0s, axis)
        gens = _generators(devs, generators)
        if seeds is not None and len(seeds) != len(devs):
            raise ValueError(f"seeds for {len(seeds)} shards given, {len(devs)} shards")
        results = []
        for i, (x, g, d) in enumerate(zip(shards, gens, devs)):
            with _on(d):
                results.append(_run_episodes_kernel(
                    env, solver, cfg, x, seeds=None if seeds is None else seeds[i],
                    generator=g, device=d))
        return _gather(results, devs[0])

    return fn
