"""Device-idle ms a frame during which a program span other than the
host's waits on the card (``engine.wait``, ``pick.readback``) was the
innermost one open on the launching thread: the card waiting on the
program's host work. Idle is the complement of the union of the device's
operations between the first and the last of the profiled frames."""

from rtbench.program_spans import WAITS, idle_by_span, program_timeline


def read(ctx):
    tl = program_timeline(ctx)
    if tl is None or not tl.ops:
        return None
    us = sum(v for name, v in idle_by_span(tl).items() if name is not None and name not in WAITS)
    return us * 1e-3 / ctx["units"]
