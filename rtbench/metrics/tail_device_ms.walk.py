"""Device ms a frame of every kernel, copy and fill launched inside
``render_frame`` other than K2.2: the frame's finish (the deferred texels
and sky), the post chain and the untiling, over the profiled frames."""

import re

#: K2.2's instantiations as the trace names them ("void render_kernel<1, ...>(...)")
K22 = re.compile(r"(void )?render_(shadow_)?kernel<")


def read(ctx):
    tl = ctx.get("timeline")
    if tl is None or ctx.get("kind") != "frames":
        return None
    inside, _ = tl.inside(lambda n: n == "rtbench.render_frame")
    ops = [op for op in inside if not K22.match(op.name)]
    if not ops:
        return None
    return sum(op.dur for op in ops) * 1e-3 / ctx["units"]
