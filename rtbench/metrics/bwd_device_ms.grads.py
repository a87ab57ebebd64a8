"""Device ms a step of the launches made inside the autograd engine's
``evaluate_function`` ranges (the backward: torch's kernels and K2.4)."""


def read(ctx):
    tl = ctx.get("timeline")
    if tl is None or ctx.get("kind") != "steps":
        return None
    inside, _ = tl.inside(lambda n: n.startswith("autograd::engine::evaluate_function"))
    if not inside:
        return None
    return sum(op.dur for op in inside) * 1e-3 / ctx["units"]
