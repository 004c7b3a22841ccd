"""Fused rollout + cost: N independent horizon-T rollouts in one launch.

Counterpart of ``benchmarking_mpc_solvers_tpu/ops/fused.py``:
``fused_rollout_costs_tm``, the hot path of the two-stage MPPI tier, and its
batch-major wrappers ``fused_rollout_costs`` (N, S), (N, T) and
``fused_rollout_cost_samples`` (K samples from one state). On a CUDA
tensor ``fused_rollout_costs_tm`` launches the hand-written kernel in
``csrc/fused_rollout.cu`` (one thread per rollout, state in registers, the
stage cost compiled for the model's own weights; the dummy past S = 8 in
the form ``dummy_plan`` picks; ``launch_config`` reports the launch shape);
on a CPU tensor it runs
``fused_rollout_costs_tm_reference``, the plain PyTorch version of the same
function; each batch-major wrapper has its own plain version too.
``fused_rollout_costs_tm.launches`` counts kernel launches, the wrappers'
included.

Scope as in the reference: single-input models (action_size == 1) with a
``quad_cost`` stage cost, and on the card only models that have a device
function in ``csrc/models.cuh`` (the plants under any weights, the dummy
family; ``_build.model_id``), the dummy past S = 8 in the kernel's dummy
form (``_build.dummy_size``).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .. import _build
from ..models.base import Model
from .rollout import rollout_cost


# The dummy form's plans (csrc/fused_rollout.cu), by the C entry points'
# form codes: "rows", the state in registers and the weights as kernel
# parameters, for S up to the widest row and a list of every state square,
# each followed or not by its action term, then the action's square or not;
# "list", the term list and the state from device memory at every step, for
# the rest.
DUMMY_FORMS = ("rows", "list")
DUMMY_ROWS = (12, 16, 20, 24, 28, 32)  # the rows form's compiled widths


class DummyPlan(NamedTuple):
    """A dummy launch: its form, the rows form's row width (0 in the list
    form) and whether its list has action terms (r, S) with r < S (rows
    form). The kernel's entry points pick the chunk of goals a block stages
    and its shared bytes; ``launch_config`` reports them."""
    form: str
    row: int
    acts: bool


class DummyRows(ctypes.Structure):
    """The rows form's weights (``csrc/fused_rollout.cu``: DummyRows): d[r]
    of (r, r), -0.0 past S; a[r] of (r, S) where bit r of ``acts`` is set;
    s of (S, S) where ``square``."""
    _fields_ = [("d", ctypes.c_float * DUMMY_ROWS[-1]), ("a", ctypes.c_float * DUMMY_ROWS[-1]),
                ("s", ctypes.c_float), ("acts", ctypes.c_uint32), ("square", ctypes.c_int)]


def _rows_weights(nz, S: int):
    """``dummy_rows`` of the terms ``nz`` in ``quad_cost``'s order, or None."""
    w, e = DummyRows(), 0
    for r in range(S):
        if e == len(nz) or nz[e][:2] != (r, r):
            return None
        w.d[r] = nz[e][2]
        e += 1
        if e < len(nz) and nz[e][:2] == (r, S):
            w.a[r] = nz[e][2]
            w.acts |= 1 << r
            e += 1
    for r in range(S, DUMMY_ROWS[-1]):
        w.d[r] = -0.0
    if e < len(nz) and nz[e][:2] == (S, S):
        w.s, w.square = nz[e][2], 1
        e += 1
    return w if e == len(nz) else None


def dummy_rows(cost, S: int):
    """The rows form's weights of a ``quad_cost`` at state size S, or None
    where its list is not of that form (or S passes the widest row). Built
    once per cost and kept on it."""
    cache = getattr(cost, "rows_w", None)
    if cache is not None and cache[0] == S:
        return cache[1]
    nz = getattr(cost, "nz", None)
    if nz is None:
        raise NotImplementedError("the kernels need a quad_cost cost")
    w = _rows_weights(nz, S) if S <= DUMMY_ROWS[-1] else None
    cost.rows_w = (S, w)
    return w


def dummy_plan(cost, S: int) -> DummyPlan:
    """The dummy form's plan for a ``quad_cost`` at state size S: the rows
    form at the narrowest row that holds S where its list allows, else the
    list form."""
    w = dummy_rows(cost, S)
    if w is None:
        return DummyPlan("list", 0, False)
    return DummyPlan("rows", next(r for r in DUMMY_ROWS if r >= S), bool(w.acts))


def launch_config(model: Model, N: int, T: int | None = None) -> dict:
    """The kernel's launch shape for N rollouts of the model on the current
    card: threads (rollouts) per block, blocks, registers per thread,
    resident blocks per SM, and the stage cost's form (``generic_cost``:
    True where the model's weights are not its functor's compiled terms).
    For the dummy past S = 8 (T steps, required there), the dummy form's:
    its plan's form and row, the steps of goals a block stages at a time
    (``chunk``, 0 in the list form), shared bytes, and the local (stack and
    spill) bytes per thread (cudaFuncAttributes.localSizeBytes) in place of
    ``generic_cost``."""
    S_dummy = _build.dummy_size(model)
    if S_dummy is not None:
        if T is None:
            raise ValueError("the dummy form's launch depends on T: pass it")
        plan = dummy_plan(model.state_cost, S_dummy)
        out = (ctypes.c_int * 7)()
        _build.check_rc("launch_config", _build.kernel_fn("fused_rollout_dummy_launch_config")(
            DUMMY_FORMS.index(plan.form), plan.row, int(plan.acts), T, N,
            ctypes.cast(out, ctypes.c_void_p)))
        keys = ("threads", "blocks", "shared_bytes", "registers", "blocks_per_sm",
                "local_bytes", "chunk")
        return {"form": plan.form, "row": plan.row, **dict(zip(keys, out))}
    out = (ctypes.c_int * 5)()
    _build.check_rc("launch_config", _build.kernel_fn("fused_rollout_launch_config")(
        _build.model_id(model), N, _build.quad_weights(model.state_cost),
        ctypes.cast(out, ctypes.c_void_p)))
    keys = ("threads", "blocks", "registers", "blocks_per_sm", "generic_cost")
    return {**dict(zip(keys, out)), "generic_cost": bool(out[4])}


def fused_rollout_costs_tm_reference(model: Model, x0_tm, us_tm, g_z):
    """Plain version: x0_tm (S, N), us_tm (T, N), g_z (T, Z) -> (N,) summed
    clipped stage costs, by ``rollout_cost`` on the batch-major layout."""
    return rollout_cost(model, x0_tm.T, us_tm.T[..., None], g_z)[0]


def fused_rollout_costs_tm(model: Model, x0_tm, us_tm, g_z):
    """Time-major summed rollout costs: x0_tm (S, N), us_tm (T, N), g_z (T, Z)
    -> (N,). The kernel on CUDA tensors, the plain version on CPU tensors."""
    if model.action_size != 1:
        raise NotImplementedError("fused rollout supports action_size == 1")
    S, N = x0_tm.shape
    T = us_tm.shape[0]
    if us_tm.shape != (T, N) or g_z.shape != (T, model.goal_size) or S != model.state_size:
        raise ValueError(
            f"shapes x0_tm {tuple(x0_tm.shape)}, us_tm {tuple(us_tm.shape)}, "
            f"g_z {tuple(g_z.shape)} do not fit model {model.name!r}")
    if x0_tm.device.type == "cpu":
        return fused_rollout_costs_tm_reference(model, x0_tm, us_tm, g_z)
    if x0_tm.device.type != "cuda":
        raise ValueError(f"unsupported device {x0_tm.device}")
    S_dummy = _build.dummy_size(model)
    mid = None if S_dummy is not None else _build.model_id(model)
    dev = x0_tm.device
    _build.check_cuda_args("fused_rollout_costs_tm", dev, x0_tm=x0_tm, us_tm=us_tm, g_z=g_z)
    out = torch.empty((N,), dtype=torch.float32, device=dev)
    if N == 0:
        return out
    args = (_build.ptr(x0_tm), _build.ptr(us_tm), _build.ptr(g_z), _build.ptr(out), T, N)
    if S_dummy is None:
        rc = _build.kernel_fn("fused_rollout_costs_launch")(
            mid, *args, _build.quad_weights(model.state_cost), _build.stream_ptr(dev))
    else:
        plan = dummy_plan(model.state_cost, S_dummy)
        if plan.form == "rows":
            w = dummy_rows(model.state_cost, S_dummy)
            rc = _build.kernel_fn("fused_rollout_dummy_rows_launch")(
                plan.row, int(plan.acts), *args, S_dummy, ctypes.addressof(w),
                _build.stream_ptr(dev))
        else:
            terms, _ = _build.dummy_terms(model.state_cost, dev)
            rc = _build.kernel_fn("fused_rollout_dummy_launch")(
                S_dummy, *args, _build.ptr(terms), terms.shape[0], _build.stream_ptr(dev))
    _build.check_rc("fused_rollout_costs_tm", rc)
    fused_rollout_costs_tm.launches += 1
    return out


fused_rollout_costs_tm.launches = 0


def fused_rollout_costs_reference(model: Model, x0b, usb, g_z):
    """Plain version of ``fused_rollout_costs``."""
    return fused_rollout_costs_tm_reference(model, x0b.T, usb.T, g_z)


def fused_rollout_costs(model: Model, x0b, usb, g_z):
    """Batch-major summed rollout costs: x0b (N, S), usb (N, T) single-input
    action sequences, g_z (T, Z) -> (N,), the contract of summing
    ``rollout``'s per-step costs. The kernel takes the time-major layout:
    the transposes are made contiguous before it sees them."""
    return fused_rollout_costs_tm(model, x0b.T.contiguous(), usb.T.contiguous(), g_z)


def fused_rollout_cost_samples_reference(model: Model, x0, samples, g_z):
    """Plain version of ``fused_rollout_cost_samples``."""
    K = samples.shape[0]
    return fused_rollout_costs_reference(model, x0.expand(K, x0.shape[0]), samples[..., 0], g_z)


def fused_rollout_cost_samples(model: Model, x0, samples, g_z):
    """(K, T, A=1) samples from one state x0 (S,) -> (K,) costs: the cost
    part of ``rollout.rollout_cost_samples`` on the kernel."""
    K = samples.shape[0]
    return fused_rollout_costs(model, x0.expand(K, x0.shape[0]), samples[..., 0], g_z)
