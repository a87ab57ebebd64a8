"""The share of the traced window, in %, in which no kernel, copy or fill
ran on the card."""


def read(ctx):
    tl = ctx.get("timeline")
    if tl is None or ctx.get("kind") != "steps":
        return None
    return 100.0 * (1.0 - tl.busy_us() * 1e-6 / ctx["window_s"])
