"""Host ms of one pick's ``pick.readback`` span (the hit record's copies
to the host, each waiting on the card), the mean over the profiled
picks."""

from rtbench.program_spans import named, program_timeline


def read(ctx):
    tl = program_timeline(ctx)
    spans = named(tl, "pick.readback") if tl is not None else []
    if not spans:
        return None
    return sum(r.end - r.ts for r in spans) * 1e-3 / len(spans)
