"""Profiling and timing utilities.

Counterpart of ``benchmarking_mpc_solvers_tpu/utils/profiling.py``:

- ``trace`` wraps ``torch.profiler`` around a block and writes a Chrome
  trace and the per-stage totals of the program's spans into its
  directory;
- ``span`` marks a stage of the program (the episode runners' batch, step,
  solve and plant; the batched MPPI and CEM solves' draw, rollout and
  update or refit). With the profiler off it is one flag read and a
  shared no-op context. Under the profiler it is a ``record_function``
  range in the trace, on the clock of the device's operations, and a pair
  of timing marks (CUDA events on the current stream; the host's clock
  where CUDA is not in use) kept in memory; ``span_totals`` sums them by
  name, ``clear_spans`` forgets them;
- ``device_step_latency`` and ``slope_timer`` estimate device time per step
  or per call from chains of two lengths, so that a chain's constant cost
  (the host's launches before the first step, the synchronization after the
  last) cancels in the difference. A chain is a Python loop of steps timed
  with CUDA events on the card and with ``time.perf_counter`` on the CPU,
  each ending in the fetch of its scalar;
- ``Timer`` is a simple wall-clock context manager for host-side phases.

The timers take an explicit ``device`` (default ``"cuda"``, which raises
without CUDA); a CPU run times the CPU and is no device measurement.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time
from typing import Callable, Optional

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler

from ..device import resolve_device

_SPANS: list = []  # (name, enclosing span's name or None, (start mark, end mark))
_OPEN: list = []  # names of the spans entered and not yet left, innermost last
_OFF = contextlib.nullcontext()


def _mark():
    """A timing mark: a CUDA event recorded on the current stream where CUDA
    is in use, else the host's clock in ns (the host is the device)."""
    if torch.cuda.is_initialized():
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event
    return time.perf_counter_ns()


class _Span:
    """A span under the profiler: a ``record_function`` range with a pair
    of timing marks inside it, appended to the recorded spans on exit."""

    __slots__ = ("name", "parent", "start", "range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.parent = _OPEN[-1] if _OPEN else None
        _OPEN.append(self.name)
        self.range = torch.profiler.record_function(self.name)
        self.range.__enter__()
        self.start = _mark()
        return self

    def __exit__(self, *exc):
        end = _mark()
        self.range.__exit__(*exc)
        _OPEN.pop()
        _SPANS.append((self.name, self.parent, (self.start, end)))
        return False


def span(name: str):
    """A context that marks a stage of the program. With the profiler off
    (the flag is read first) it is a shared no-op: nothing is allocated or
    recorded. Under ``torch.profiler`` it enters ``record_function(name)``
    and records a pair of timing marks with the enclosing span's name."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name)


def span_totals(under: Optional[str] = None) -> dict:
    """``{name: {"count": n, "device_ms": total}}`` over the recorded spans,
    or over those whose enclosing span is named ``under``. Waits once for
    the recorded CUDA events; a span's ``device_ms`` is the time between
    its marks on the device's stream (the host's clock on the CPU)."""
    picked = [(name, marks) for name, parent, marks in _SPANS
              if under is None or parent == under]
    if any(isinstance(marks[0], torch.cuda.Event) for _, marks in picked):
        torch.cuda.synchronize()
    out = {}
    for name, (start, end) in picked:
        ms = (start.elapsed_time(end) if isinstance(start, torch.cuda.Event)
              else (end - start) * 1e-6)
        total = out.setdefault(name, {"count": 0, "device_ms": 0.0})
        total["count"] += 1
        total["device_ms"] += ms
    return out


def clear_spans():
    """Forget the recorded spans."""
    _SPANS.clear()


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """Profile a block with ``torch.profiler`` (CPU activity, and CUDA
    activity where a card is present) and write the Chrome trace
    ``trace.json`` (the program's spans are ``user_annotation`` ranges in
    it) and ``spans.json`` (``span_totals()`` of the block) into ``log_dir``
    (default: ``torch-trace`` in the temporary directory). Yields
    ``log_dir``."""
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "torch-trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    clear_spans()
    with torch.profiler.profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    with open(os.path.join(log_dir, "spans.json"), "w") as f:
        json.dump(span_totals(), f, indent=1, sort_keys=True)


class Timer:
    def __init__(self, name: str = ""):
        self.name = name
        self.elapsed = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self._t0
        return False


def _seconds(device: torch.device, run: Callable) -> float:
    """Seconds of ``run()``, which returns a scalar tensor: CUDA events
    around it on the card, the host clock on the CPU; either ends in the
    scalar's fetch."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        float(run())
        return time.perf_counter() - t0
    with torch.cuda.device(device):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = run()
        end.record()
        end.synchronize()
        float(out)
        return start.elapsed_time(end) / 1e3


def device_step_latency(
    step_fn: Callable,
    carry,
    inputs,
    n_lo: int = 4,
    samples: int = 12,
    target_s: float = 0.35,
    max_hi: int = 160,
    return_stats: bool = False,
    device="cuda",
    min_hi: int = 8,
):
    """Per-step device latency percentiles, in ms, free of each chain's
    constant cost.

    A measurement chains ``n`` steps ``step_fn(carry, inputs[i % n_inputs])
    -> (carry, scalar)`` and times the chain (CUDA events on the card, the
    host clock after the scalar's fetch on the CPU) at two chain lengths;
    per-step samples ``(t_hi - t_lo) / (n_hi - n_lo)`` cancel the constant
    pairwise. ``inputs``: per-step inputs along a leading axis (a tensor,
    an array or a list), taken cyclically so both chain lengths see the
    same per-step inputs. Returns ``(p50_ms, p90_ms)`` over
    ``samples`` interleaved lo/hi pairs.

    The paired differences can go slightly negative on sub-microsecond
    steps; the percentiles are clamped at 0. With ``return_stats=True``
    returns ``(p50_ms, p90_ms, resolution_ms)``, ``resolution_ms`` the
    sample standard deviation of the per-step estimates: a latency at or
    below it reads as "< resolution", not as a measurement. The long chain
    has at least ``min_hi`` steps more than the short one (the reference's
    8); a step long beside a chain's constant needs fewer.
    """
    device = resolve_device(device)
    n_inputs = len(inputs)

    def chain(n):
        c, acc = carry, torch.zeros((), device=device)
        for i in range(n):
            c, chk = step_fn(c, inputs[i % n_inputs])
            acc = acc + chk
        return acc

    def run(n):
        return _seconds(device, lambda: chain(n))

    # size the long chain so the device time dominates the constant: the
    # n_lo chain's time gives a first guess, one paired difference at that
    # guess a constant-free estimate that sizes the final chain
    def size_hi(est):
        return n_lo + int(max(min_hi, min(max_hi, round(target_s / max(est, 1e-5)))))

    run(n_lo)  # warm-up
    est = run(n_lo) / n_lo
    n_hi = size_hi(est)
    est2 = max((run(n_hi) - run(n_lo)) / (n_hi - n_lo), 1e-7)
    n_hi2 = size_hi(est2)
    if n_hi2 > 2 * n_hi:
        n_hi = n_hi2

    per_step = []
    for _ in range(samples):
        t_lo = run(n_lo)
        t_hi = run(n_hi)
        per_step.append((t_hi - t_lo) / (n_hi - n_lo))
    # a latency cannot be negative
    p50 = max(0.0, float(np.percentile(per_step, 50) * 1e3))
    p90 = max(0.0, float(np.percentile(per_step, 90) * 1e3))
    if return_stats:
        resolution = float(np.std(per_step, ddof=1) * 1e3)
        return p50, p90, resolution
    return p50, p90


def slope_timer(
    fn: Callable,
    generator: Optional[torch.Generator] = None,
    inner_reps: int = 9,
    outer_reps: int = 3,
    device="cuda",
) -> float:
    """Device seconds per call of ``fn(generator) -> scalar``.

    Times chains of 1 and ``inner_reps`` calls, ``outer_reps`` times each
    after a warm-up, and returns the slope: the chain's constant cost
    cancels. ``fn`` draws its inputs from the generator, so each repetition
    sees fresh inputs, and returns a scalar tensor (the chain sums them).
    ``generator`` defaults to one on ``device`` seeded with 0.
    """
    device = resolve_device(device)
    gen = generator if generator is not None else torch.Generator(device=device).manual_seed(0)

    def repeated(n):
        acc = torch.zeros((), device=device)
        for _ in range(n):
            acc = acc + fn(gen)
        return acc

    times = {}
    for n in (1, inner_reps):
        _seconds(device, lambda n=n: repeated(n))  # warm-up
        times[n] = sum(_seconds(device, lambda n=n: repeated(n))
                       for _ in range(outer_reps)) / outer_reps
    return (times[inner_reps] - times[1]) / (inner_reps - 1)
