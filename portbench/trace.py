"""The device trace of a short steady stretch of the window, and its
reduction to what the per-layer readers take.

``profile_stretch`` runs a few of the window's batches under
``torch.profiler`` (CPU and CUDA activity) inside a ``portbench.stretch``
range, writes the Chrome trace to a temporary file under ``TMPDIR``, reads
it back and deletes it. ``Trace`` holds the stretch's interval, its device
operations (kernels, copies, sets) and its host events, all in µs of one
clock. Busy time is the union of the device operations' intervals; an idle
gap is named by the innermost torch op under its midpoint, else by the
harness's range there (``portbench.inputs``, ``.episodes``, ``.fetch``).
"""

from __future__ import annotations

import bisect
import json
import os
import re
import tempfile
from collections import defaultdict
from dataclasses import dataclass, field
from pathlib import Path

STRETCH = "portbench.stretch"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HERE = Path(__file__).resolve().parent


@dataclass
class Trace:
    span: tuple  # (start, end) µs of the stretch on the host clock
    device_ops: list  # (name, start, end, cat) µs
    host: list = field(default_factory=list)  # torch ops: (name, start, end) µs, by start
    notes: list = field(default_factory=list)  # the harness's ranges: (name, start, end)
    steps: int = 0  # MPC steps (scenario batches x episode length) in the stretch

    @property
    def kernels(self) -> list:
        return [op for op in self.device_ops if op[3] == "kernel"]

    @property
    def window_s(self) -> float:
        return (self.span[1] - self.span[0]) * 1e-6

    def busy_intervals(self) -> list:
        merged = []
        for _, s, e, _ in sorted(self.device_ops, key=lambda op: op[1]):
            s, e = max(s, self.span[0]), min(e, self.span[1])
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-6

    def gaps(self) -> list:
        """(start, end) µs of the stretch's device idle gaps."""
        out, cur = [], self.span[0]
        for s, e in self.busy_intervals():
            if s > cur:
                out.append((cur, s))
            cur = max(cur, e)
        if self.span[1] > cur:
            out.append((cur, self.span[1]))
        return out

    def host_at(self, t: float, starts: list, look_back: int = 2000) -> str:
        """The innermost torch op under time t (µs) among the ``look_back``
        that started last before it, else the innermost harness range, else
        'host: outside torch ops'. ``starts``: the torch ops' start times."""
        best = None
        hi = bisect.bisect_right(starts, t)
        for name, s, e in self.host[max(0, hi - look_back):hi]:
            if e >= t and (best is None or e - s < best[1]):
                best = (name, e - s)
        if best is None:
            for name, s, e in self.notes:
                if s <= t <= e and (best is None or e - s < best[1]):
                    best = (name, e - s)
        return best[0] if best else "host: outside torch ops"

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time and the longest idle
        gaps by what the host was doing, in seconds."""
        ops, idle = defaultdict(float), defaultdict(float)
        for name, s, e, _ in self.device_ops:
            ops[short(name)] += (e - s) * 1e-6
        starts = [h[1] for h in self.host]
        for s, e in self.gaps():
            idle[short(self.host_at(0.5 * (s + e), starts))] += (e - s) * 1e-6
        return {"device_ops": _top(ops, top), "idle_gaps": _top(idle, top)}

    def kernel_times(self, pattern: str) -> list:
        """Durations in s of the kernels whose name matches ``pattern``."""
        rx = re.compile(pattern)
        return [(e - s) * 1e-6 for name, s, e, _ in self.kernels if rx.search(name)]


def _top(totals: dict, n: int) -> list:
    return [[k, v] for k, v in sorted(totals.items(), key=lambda kv: -kv[1])[:n]]


def short(name: str, width: int = 120) -> str:
    return name if len(name) <= width else name[: width - 3] + "..."


def hand_written() -> dict:
    """The program's hand-written kernels: short name -> name pattern."""
    return json.loads((HERE / "kernels.json").read_text())["patterns"]


def from_chrome(doc: dict, steps: int) -> Trace:
    """The stretch of a Chrome trace (``torch.profiler``'s export)."""
    events = [ev for ev in doc.get("traceEvents", []) if ev.get("ph") == "X"]
    spans = [ev for ev in events
             if ev.get("name") == STRETCH and ev.get("cat") == "user_annotation"]
    if not spans:
        raise ValueError(f"the trace has no {STRETCH} range")
    s0 = float(spans[0]["ts"])
    span = (s0, s0 + float(spans[0]["dur"]))
    dev = [(ev["name"], float(ev["ts"]), float(ev["ts"]) + float(ev.get("dur", 0.0)), ev["cat"])
           for ev in events if ev.get("cat") in DEVICE_CATS]
    dev = [op for op in dev if op[2] > span[0] and op[1] < span[1]]

    def host(cat):
        return sorted(((ev["name"], float(ev["ts"]), float(ev["ts"]) + float(ev.get("dur", 0.0)))
                       for ev in events if ev.get("cat") == cat and ev.get("name") != STRETCH),
                      key=lambda h: h[1])
    return Trace(span, dev, host("cpu_op"), host("user_annotation"), steps)


def profile_stretch(run_batches) -> Trace:
    """Runs ``run_batches()``, which returns the MPC steps it made, under
    the profiler and returns the stretch's ``Trace``."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(STRETCH):
            steps = run_batches()
    fd, path = tempfile.mkstemp(prefix="portbench-trace-", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        doc = json.loads(Path(path).read_text())
    finally:
        os.remove(path)
    return from_chrome(doc, steps)
