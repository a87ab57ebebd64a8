"""Device ms a step of the launches made outside the autograd engine's
``evaluate_function`` ranges: the no-grad traversal (K2.1), the
differentiable recompute (K2.3, the shading) and the reads of the
gradients."""


def read(ctx):
    tl = ctx.get("timeline")
    if tl is None or ctx.get("kind") != "steps":
        return None
    _, outside = tl.inside(lambda n: n.startswith("autograd::engine::evaluate_function"))
    if not outside:
        return None
    return sum(op.dur for op in outside) * 1e-3 / ctx["units"]
