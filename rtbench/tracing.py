# device_ops: frozen copy of clraytracer_tpu_torch/tools/profile_step.py (device_ops, DEVICE_CATEGORIES) at commit c1cdb28.
"""The traced run's device timeline: ``torch.profiler`` over a steady part
of the window, read back from its Chrome trace.

A device operation is a kernel, copy or fill on the card. Each one is tied
to the host call that launched it through the trace's correlation id, so
that it can be put inside or outside a host range: a ``record_function``
range of the benchmark (``rtbench.render_frame``) or one of the autograd
engine (``evaluate_function``).
"""

from __future__ import annotations

import bisect
import json
import os
from typing import NamedTuple

#: the trace's categories of work on the card
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
#: the host calls that launch them
LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")


class DeviceOp(NamedTuple):
    name: str
    ts: float  # us
    dur: float  # us
    launch_ts: float | None  # us, the launching host call's start
    launch_tid: object


class Range(NamedTuple):
    name: str
    ts: float
    end: float
    tid: object


def device_ops(ops: list[DeviceOp]) -> list[tuple[float, int, str]]:
    """(us, launches, name) of each kernel, copy or fill name on the card,
    most time first."""
    by_name: dict[str, tuple[float, int]] = {}
    for op in ops:
        us, n = by_name.get(op.name, (0.0, 0))
        by_name[op.name] = (us + op.dur, n + 1)
    return sorted(((us, n, k) for k, (us, n) in by_name.items()), reverse=True)


class Timeline:
    """The device operations and host ranges of one profiled section."""

    def __init__(self, events: list[dict]) -> None:
        launches = {}
        for e in events:
            if e.get("ph") == "X" and e.get("cat") in LAUNCH_CATEGORIES:
                corr = (e.get("args") or {}).get("correlation")
                if corr is not None:
                    launches[corr] = (float(e["ts"]), e.get("tid"))
        self.ops: list[DeviceOp] = []
        self.ranges: list[Range] = []
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat")
            if cat in DEVICE_CATEGORIES:
                corr = (e.get("args") or {}).get("correlation")
                ts, tid = launches.get(corr, (None, None))
                self.ops.append(DeviceOp(e["name"], float(e["ts"]), float(e.get("dur", 0.0)),
                                         ts, tid))
            elif cat in ("user_annotation", "cpu_op"):
                ts = float(e["ts"])
                self.ranges.append(Range(e["name"], ts, ts + float(e.get("dur", 0.0)),
                                         e.get("tid")))
        self.ops.sort(key=lambda o: o.ts)

    @classmethod
    def from_profile(cls, prof, path: str) -> "Timeline":
        """Export ``prof``'s trace to ``path``, read it and delete it."""
        prof.export_chrome_trace(path)
        try:
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        return cls(events)

    def inside(self, match) -> tuple[list[DeviceOp], list[DeviceOp]]:
        """The operations launched inside a host range whose name ``match``
        accepts (on the launching thread), and the others."""
        spans: dict[object, list[tuple[float, float]]] = {}
        for r in self.ranges:
            if match(r.name):
                spans.setdefault(r.tid, []).append((r.ts, r.end))
        starts = {}
        for tid, s in spans.items():
            s.sort()
            merged = []
            for a, b in s:
                if merged and a <= merged[-1][1]:
                    merged[-1][1] = max(merged[-1][1], b)
                else:
                    merged.append([a, b])
            spans[tid] = merged
            starts[tid] = [a for a, _ in merged]
        yes, no = [], []
        for op in self.ops:
            s = spans.get(op.launch_tid)
            hit = False
            if s is not None and op.launch_ts is not None:
                k = bisect.bisect_right(starts[op.launch_tid], op.launch_ts) - 1
                hit = k >= 0 and op.launch_ts <= s[k][1]
            (yes if hit else no).append(op)
        return yes, no

    def busy_us(self, ops: list[DeviceOp] | None = None) -> float:
        """Microseconds in which at least one of ``ops`` (all by default)
        ran on the card: the union of their intervals."""
        ops = self.ops if ops is None else sorted(ops, key=lambda o: o.ts)
        total, end = 0.0, float("-inf")
        for op in ops:
            a, b = op.ts, op.ts + op.dur
            if b <= end:
                continue
            total += b - max(a, end)
            end = b
        return total

    def idle_gaps(self, top: int = 10) -> list[tuple[str, float]]:
        """The longest gaps between device operations, each named by the
        host range (innermost benchmark range, else the operation after
        the gap) that was open on the launching thread when the gap
        ended: [(name, seconds)], longest first."""
        gaps = []
        end = None
        for op in self.ops:
            if end is not None and op.ts > end:
                gaps.append((op.ts - end, op))
            end = op.ts + op.dur if end is None else max(end, op.ts + op.dur)
        gaps.sort(key=lambda g: g[0], reverse=True)
        out = []
        for us, op in gaps[:top]:
            label = "before " + op.name[:80]
            if op.launch_ts is not None:
                open_ = [r for r in self.ranges if r.tid == op.launch_tid
                         and r.name.startswith("rtbench.") and r.ts <= op.launch_ts <= r.end]
                if open_:
                    label = min(open_, key=lambda r: r.end - r.ts).name + ": " + label
            out.append((label, us * 1e-6))
        return out
