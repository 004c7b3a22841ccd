"""The program's spans (``utils.profiling.span`` in the port) over a traced
stretch, as the per-layer readers take them.

A span is recorded twice: its pair of timing marks in the program's memory
(``span_totals``: the time between them on the card's stream), and its
``user_annotation`` range in the Chrome trace (``Trace.notes``: the host's
interval, on the clock of the device's operations). A program without
spans gives nothing to read, and neither does a stretch whose recorded
``episode.step`` spans, in memory or in the trace, are not its steps.

Device idle time is put down to the stage the host was in: each idle µs of
the stretch goes to ``solve`` while an ``episode.solve`` span is open (its
``mppi.*``/``cem.*`` stages lie inside it), else to ``plant`` under
``episode.plant``, else to ``runner`` under the other ``episode.*`` spans
(batch, step, warm start), else to ``outside``: the harness's inputs and
fetch between batches. The four parts sum to the stretch's idle time.
"""

from __future__ import annotations

BATCH, STEP, SOLVE, PLANT = "episode.batch", "episode.step", "episode.solve", "episode.plant"
PARTS = ("solve", "plant", "runner", "outside")


def span_totals(under: str):
    """The program's ``span_totals(under)``, or None where it records no spans."""
    from benchmarking_mpc_solvers_tpu_torch.utils import profiling

    totals = getattr(profiling, "span_totals", None)
    return totals(under) if totals else None


def episode_notes(trace) -> list:
    """The stretch's ``episode.*`` ranges on the host: (name, start, end) µs."""
    lo, hi = trace.span
    return [(n, s, e) for n, s, e in trace.notes
            if n.startswith("episode.") and e > lo and s < hi]


def steps_match(ctx) -> bool:
    """The stretch's steps were each recorded once, in memory and in the trace."""
    if ctx.trace is None or not ctx.trace.steps:
        return False
    totals = span_totals(BATCH)
    if totals is None:
        return False
    in_trace = sum(1 for n, _, _ in episode_notes(ctx.trace) if n == STEP)
    return totals.get(STEP, {}).get("count") == ctx.trace.steps == in_trace


def device_ms_per_step(ctx, name: str, under: str):
    """Device ms of the ``name`` spans inside ``under`` spans, per MPC step."""
    if not steps_match(ctx):
        return None
    total = span_totals(under).get(name)
    return None if total is None else total["device_ms"] / ctx.trace.steps


def _stages(trace) -> list:
    """Disjoint (start, end, part) µs between the boundaries of the stretch's
    ``episode.*`` ranges, each with the part the host was in there."""
    marks = []
    for name, s, e in episode_notes(trace):
        kind = {SOLVE: 0, PLANT: 1}.get(name, 2)
        marks += [(s, kind, 1), (e, kind, -1)]
    marks.sort(key=lambda m: m[0])
    depth, out, prev = [0, 0, 0], [], None
    for t, kind, step in marks:
        if prev is not None and t > prev:
            out.append((prev, t, PARTS[next((i for i in range(3) if depth[i]), 3)]))
        depth[kind] += step
        prev = t
    return out


def idle_split(trace) -> dict:
    """The stretch's device idle µs by part (``PARTS``): each gap split by
    intersection with the host's stages."""
    out = dict.fromkeys(PARTS, 0.0)
    stages, j = _stages(trace), 0
    for gs, ge in trace.gaps():
        while j < len(stages) and stages[j][1] <= gs:
            j += 1
        covered, k = 0.0, j
        while k < len(stages) and stages[k][0] < ge:
            s, e, part = stages[k]
            piece = min(ge, e) - max(gs, s)
            out[part] += piece
            covered += piece
            k += 1
        out["outside"] += (ge - gs) - covered
    return out


def idle_ms_per_step(ctx, part: str):
    """Device idle ms while the host was in ``part``, per MPC step."""
    if not steps_match(ctx):
        return None
    return idle_split(ctx.trace)[part] * 1e-3 / ctx.trace.steps
