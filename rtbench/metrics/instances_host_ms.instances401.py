"""Host ms a frame of the program's ``engine.instances`` span (the tick's
instance table: its inverse transforms and material starts, the pinned
upload), over the profiled frames."""

from rtbench.program_spans import host_ms_a_frame


def read(ctx):
    return host_ms_a_frame(ctx, "engine.instances")
