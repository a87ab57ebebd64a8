"""Scope timers and the profiler-stat sink (the JAX package's
``utils/timer.py``; the reference's ``Timer``/``CSTIMER``, Timer.hpp:7-44,
and ``Engine_UpdateProfilerStats``, Engine.cpp:36-39).

``ScopeTimer`` is the port's one span primitive. It reads the host clock
around its scope, as in the JAX package: work a scope queues on the card
may still run after it. While a ``torch.profiler`` records, it also opens
a range of the same name, so that the profiler's trace holds the span on
the clock of the card's kernels, copies and fills; while none records it
opens none.
"""

from __future__ import annotations

from time import perf_counter

import torch
import torch.autograd.profiler as _autograd_profiler

from clraytracer_tpu_torch.utils.logging import get_logger

#: Last-seen timings keyed by stat name, in milliseconds (the reference's
#: ``ProfilerSpeeds`` array, Engine.cpp:34-38).
profiler_stats: dict[str, float] = {}

#: the profiler range a span opens: torch's cheap one where it has it
#: (about a tenth of ``record_function``'s cost a range)
_Range = getattr(torch._C._profiler, "_RecordFunctionFast", None) or _autograd_profiler.record_function


def update_profiler_stat(name: str, ms: float) -> None:
    profiler_stats[name] = ms


class ScopeTimer:
    """Host ms of a scope, recorded into :data:`profiler_stats` under
    ``name``, and a profiler range of that name while a profiler records.
    With the profiler off it costs a flag read, two clock reads and a dict
    store."""

    __slots__ = ("name", "log", "_start", "_range")

    def __init__(self, name: str, log: bool = True) -> None:
        self.name = name
        self.log = log

    def __enter__(self) -> None:
        if _autograd_profiler._is_profiler_enabled:
            self._range = _Range(self.name)
            self._range.__enter__()
        else:
            self._range = None
        self._start = perf_counter()

    def __exit__(self, *exc) -> None:
        ms = (perf_counter() - self._start) * 1e3
        if self._range is not None:
            self._range.__exit__(None, None, None)
        profiler_stats[self.name] = ms
        if self.log:
            get_logger().info("%s took %.2f ms", self.name, ms)
