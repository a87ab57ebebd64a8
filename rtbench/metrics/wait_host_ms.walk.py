"""Host ms a frame of the program's ``engine.wait`` span, the watchdog's
synchronise: near 0 the frame is host-bound, near the frame's device ms
it is device-bound. Over the profiled frames; none on the CPU."""

from rtbench.program_spans import host_ms_a_frame


def read(ctx):
    return host_ms_a_frame(ctx, "engine.wait")
