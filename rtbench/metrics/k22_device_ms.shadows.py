"""Device ms a frame of K2.2's shadow instantiations
(``render_shadow_kernel*`` launched inside ``render_frame``), over the
profiled frames. None where no shadow instantiation ran: a frame that
dropped its shadow walk reads as nothing, never as a faster K2.2."""

import re

#: as the trace names them ("void render_shadow_kernel<1, false, false, 0>(...)")
SHADOW_K22 = re.compile(r"(void )?render_shadow_kernel<")


def read(ctx):
    tl = ctx.get("timeline")
    if tl is None or ctx.get("kind") != "frames":
        return None
    inside, _ = tl.inside(lambda n: n == "rtbench.render_frame")
    ops = [op for op in inside if SHADOW_K22.match(op.name)]
    if not ops:
        return None
    return sum(op.dur for op in ops) * 1e-3 / ctx["units"]
