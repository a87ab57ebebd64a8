"""Host ms a frame of the program's ``engine.tick`` span (the instance
upload and the shading tables' rebuild), over the profiled frames."""

from rtbench.program_spans import host_ms_a_frame


def read(ctx):
    return host_ms_a_frame(ctx, "engine.tick")
