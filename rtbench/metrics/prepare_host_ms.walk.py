"""Host ms a frame of the program's ``render.prepare`` span (the frame's
tables, atlas mode and camera row before K2.2's launch: what the card
waits on before K2.2), over the profiled frames."""

from rtbench.program_spans import host_ms_a_frame


def read(ctx):
    return host_ms_a_frame(ctx, "render.prepare")
