"""The program's own spans in a traced run's timeline.

``clraytracer_tpu_torch``'s ``ScopeTimer`` opens a profiler range of its
span's name while the profiler records, on the clock of the card's
kernels, copies and fills. Its names begin with the layer that opens them
(``PREFIXES``). A commit without such spans leaves none in the trace, and
every reader of this module then returns None.
"""

from __future__ import annotations

from collections import Counter

#: the first part of a program span's name: the layer that opens it
PREFIXES = ("engine.", "tables.", "render.", "pick.")
#: the spans in which the host waits on the card: the watchdog's
#: synchronise and the pick's copies to the host
WAITS = ("engine.wait", "pick.readback")


def named(tl, name: str) -> list:
    """The ranges of the timeline called ``name``."""
    return [r for r in tl.ranges if r.name == name]


def program_timeline(ctx):
    """The timeline of a traced run of frames that holds program spans,
    else None."""
    tl = ctx.get("timeline")
    if tl is None or ctx.get("kind") != "frames" or not named(tl, "engine.render"):
        return None
    return tl


def host_ms_a_frame(ctx, name: str) -> float | None:
    """Host ms a profiled frame inside the spans called ``name``."""
    tl = program_timeline(ctx)
    spans = named(tl, name) if tl is not None else []
    if not spans:
        return None
    return sum(r.end - r.ts for r in spans) * 1e-3 / ctx["units"]


def _innermost(spans) -> list[tuple[float, float, str]]:
    """Properly nested ranges of one thread → disjoint (start, end, name)
    pieces in time order, each named by the innermost range open there."""
    out, stack, cursor = [], [], None
    for r in sorted(spans, key=lambda r: (r.ts, -r.end)):
        while stack and stack[-1][0] <= r.ts:
            end, name = stack.pop()
            out.append((cursor, end, name))
            cursor = end
        if stack:
            out.append((cursor, r.ts, stack[-1][1]))
        stack.append((min(r.end, stack[-1][0]) if stack else r.end, r.name))
        cursor = r.ts
    while stack:
        end, name = stack.pop()
        out.append((cursor, end, name))
        cursor = end
    return [p for p in out if p[1] > p[0]]


def _union(intervals) -> list[tuple[float, float]]:
    merged: list[list[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def idle_gaps(tl) -> list[tuple[float, float]]:
    """The device's idle intervals (us) between its first and its last
    operation: the complement of the union of the operations."""
    busy = _union((op.ts, op.ts + op.dur) for op in tl.ops)
    return [(a[1], b[0]) for a, b in zip(busy, busy[1:])]


def _clip(gaps, within) -> list[tuple[float, float]]:
    """``gaps`` cut to the union of the intervals ``within``."""
    keep = _union(within)
    out, k = [], 0
    for a, b in gaps:
        while k < len(keep) and keep[k][1] <= a:
            k += 1
        j = k
        while j < len(keep) and keep[j][0] < b:
            lo, hi = max(a, keep[j][0]), min(b, keep[j][1])
            if hi > lo:
                out.append((lo, hi))
            j += 1
    return out


def idle_by_span(tl, within: str | None = None) -> dict:
    """Device-idle us by the innermost program span open meanwhile on the
    thread that launched most operations ({name: us}; None: no program
    span open), over the gaps between the first and the last operation,
    cut to the ranges called ``within`` where given."""
    launchers = Counter(op.launch_tid for op in tl.ops if op.launch_tid is not None)
    gaps = idle_gaps(tl)
    if within is not None:
        gaps = _clip(gaps, [(r.ts, r.end) for r in named(tl, within)])
    by: dict = {None: sum(b - a for a, b in gaps)}
    if not launchers:
        return by
    tid = launchers.most_common(1)[0][0]
    pieces = _innermost(r for r in tl.ranges if r.name.startswith(PREFIXES) and r.tid == tid)
    k = 0
    for a, b, name in pieces:
        while k < len(gaps) and gaps[k][1] <= a:
            k += 1
        j = k
        while j < len(gaps) and gaps[j][0] < b:
            us = min(b, gaps[j][1]) - max(a, gaps[j][0])
            if us > 0:
                by[name] = by.get(name, 0.0) + us
                by[None] -= us
            j += 1
    return by
