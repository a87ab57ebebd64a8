"""Scope timers and the profiler-stat sink (the JAX package's
``utils/timer.py``; the reference's ``Timer``/``CSTIMER``, Timer.hpp:7-44,
and ``Engine_UpdateProfilerStats``, Engine.cpp:36-39).

``ScopeTimer`` reads the host clock around its scope, as in the JAX
package: work a scope queues on the card may still run after it. ``timed``
waits for the card (``torch.cuda.synchronize``) before it reads the clock
where the JAX decorator blocks on the outputs.
"""

from __future__ import annotations

import contextlib
import functools
import time
from typing import Any, Callable, Iterator, TypeVar

import torch

from clraytracer_tpu_torch.utils.logging import get_logger

_F = TypeVar("_F", bound=Callable[..., Any])

#: Last-seen timings keyed by stat name, in milliseconds (the reference's
#: ``ProfilerSpeeds`` array, Engine.cpp:34-38).
profiler_stats: dict[str, float] = {}


def update_profiler_stat(name: str, ms: float) -> None:
    profiler_stats[name] = ms


@contextlib.contextmanager
def ScopeTimer(name: str, log: bool = True) -> Iterator[None]:
    """Host ms of a scope, recorded into :data:`profiler_stats`."""
    start = time.perf_counter()
    try:
        yield
    finally:
        ms = (time.perf_counter() - start) * 1e3
        update_profiler_stat(name, ms)
        if log:
            get_logger().info("%s took %.2f ms", name, ms)


def timed(name: str | None = None) -> Callable[[_F], _F]:
    """Decorator form of :func:`ScopeTimer` whose clock stops after the
    card has finished the call's work."""

    def deco(fn: _F) -> _F:
        label = name or fn.__qualname__

        @functools.wraps(fn)
        def wrapper(*args: Any, **kwargs: Any) -> Any:
            start = time.perf_counter()
            out = fn(*args, **kwargs)
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            update_profiler_stat(label, (time.perf_counter() - start) * 1e3)
            return out

        return wrapper  # type: ignore[return-value]

    return deco
