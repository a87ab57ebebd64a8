"""Builds of the program's tables a frame: its ``tables.*`` spans (one
range is one build of the shading, kernel or frame tables), over the
profiled frames."""

from rtbench.program_spans import program_timeline


def read(ctx):
    tl = program_timeline(ctx)
    if tl is None:
        return None
    return sum(r.name.startswith("tables.") for r in tl.ranges) / ctx["units"]
