"""Kernel, copy and fill launches a step on the card."""


def read(ctx):
    tl = ctx.get("timeline")
    if tl is None or ctx.get("kind") != "steps" or not tl.ops:
        return None
    return len(tl.ops) / ctx["units"]
