"""Profiling and timing utilities.

Counterpart of ``benchmarking_mpc_solvers_tpu/utils/profiling.py``:

- ``trace`` wraps ``torch.profiler`` around a block and writes a Chrome
  trace into its directory;
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
import os
import tempfile
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..device import resolve_device


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """Profile a block with ``torch.profiler`` (CPU activity, and CUDA
    activity where a card is present) and write the Chrome trace
    ``trace.json`` into ``log_dir`` (default: ``torch-trace`` in the
    temporary directory). Yields ``log_dir``."""
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "torch-trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


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
