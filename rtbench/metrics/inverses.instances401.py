"""Instance transforms inverted a frame: the program's ``engine.inverse``
ranges (one an inversion) over the profiled frames. None where the trace
holds no ``engine.instances`` span: a program without this counter."""

from rtbench.program_spans import named, program_timeline


def read(ctx):
    tl = program_timeline(ctx)
    if tl is None or not named(tl, "engine.instances"):
        return None
    return len(named(tl, "engine.inverse")) / ctx["units"]
