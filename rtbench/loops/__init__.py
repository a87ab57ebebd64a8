"""The loops a traffic mix names, one module each, found by file:
``loops/<name>.py`` (a mix's ``loop``) holds ``run(r: Run) -> Outcome``,
which builds the cell's scene from the seed, warms up the cell's own
shapes, measures for the window, optionally profiles a steady part of it,
and then compares a seeded sample of the window's answers with the plain
reference once the program's state is freed; and ``control(r: Run) ->
dict``, the same comparison with the reference one precision lower in the
program's place. A new loop is a new file; this module holds what they
share.
"""

from __future__ import annotations

import dataclasses
import importlib
import math
import time

import numpy as np
import torch


@dataclasses.dataclass
class Run:
    """One run of a cell."""

    cell: str
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    root: object  # the benchmark's directory (pathlib.Path)
    t0: float  # perf_counter at process start
    first_error: str | None = None


@dataclasses.dataclass
class Outcome:
    attempted: int
    failed: int
    end_to_end: dict  # {metric: value}
    numbers: dict  # {compared number: value}
    context: dict  # what the per-layer readers read
    memory_peak_bytes: int
    window_s: float | None = None
    busy_s: float | None = None
    breakdown: dict | None = None


def scene_spec(run: Run):
    return importlib.import_module(f"rtbench.scenes.{run.config['scene']}").build(
        run.config, run.seed)


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def free(dev: torch.device) -> None:
    """Wait for the device and hand its cached blocks back, once the
    program's state is dropped and before the reference runs."""
    sync(dev)
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def p95(values: list[float]) -> float:
    """The 95th percentile (nearest rank) of ``values``."""
    s = sorted(values)
    return s[max(0, math.ceil(0.95 * len(s)) - 1)]


class Reservoir:
    """A uniform sample of ``k`` items of a stream, drawn from a seed."""

    def __init__(self, k: int, seed: int, salt: int) -> None:
        self.k, self.items, self.seen = k, [], 0
        self.rng = np.random.default_rng([seed, salt])

    def offer(self, item_fn) -> None:
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item_fn())
        else:
            j = int(self.rng.integers(self.seen))
            if j < self.k:
                self.items[j] = item_fn()


class Profile:
    """``torch.profiler`` over units [first, first + count) of the window."""

    def __init__(self, run: Run, first: int, count: int) -> None:
        self.run, self.first, self.count = run, first, count
        self.prof = None
        self.window_s = None
        self.paused = 0.0  # seconds the profiler's stop took: not the window's

    def profiled(self, i: int) -> bool:
        return self.run.trace and self.first <= i < self.first + self.count

    def before(self, i: int) -> None:
        if self.run.trace and i == self.first:
            from torch.profiler import ProfilerActivity, profile

            sync(self.run.device)
            self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            self.prof.__enter__()
            self._t = time.perf_counter()

    def after(self, i: int) -> None:
        if self.prof is not None and self.window_s is None and i == self.first + self.count - 1:
            self.close(i)

    def close(self, i: int) -> None:
        """Stop profiling after unit ``i``, if it still runs (a window that
        ended early profiles the units it had)."""
        if self.prof is not None and self.window_s is None:
            sync(self.run.device)
            t = time.perf_counter()
            self.window_s = t - self._t
            self.prof.__exit__(None, None, None)
            self.count = i - self.first + 1
            self.paused = time.perf_counter() - t

    def timeline(self):
        from rtbench.tracing import Timeline

        if self.window_s is None:
            raise RuntimeError(f"the window ended before unit {self.first} was profiled")
        tmp = self.run.root / "_work"
        tmp.mkdir(exist_ok=True)
        return Timeline.from_profile(self.prof, str(tmp / "trace.json"))


def breakdown(tl) -> tuple[dict, float]:
    """The result line's ``breakdown`` and the busy seconds of a timeline."""
    from rtbench.tracing import device_ops

    busy_s = tl.busy_us() * 1e-6
    ops = [[name, us * 1e-6] for us, _n, name in device_ops(tl.ops)[:10]]
    return {"device_ops": ops, "idle_gaps": [[n, s] for n, s in tl.idle_gaps(10)]}, busy_s
