"""The shadowed frame's share of its bandwidth roofline, in %: the bytes
its inputs need (``rtbench.roofline``'s count with the triangles the
reference's shadow rays hit, ``loops/shadowframes.py``) at the card's peak
bandwidth, over the device time of every kernel, copy and fill launched
inside ``render_frame``. None where no shadow instantiation of K2.2 ran
there: the count holds the shadow walk's triangles."""

from rtbench import cells
from rtbench.roofline import PEAK_BYTES_PER_S


def read(ctx):
    tl = ctx.get("timeline")
    if tl is None or ctx.get("kind") != "frames" or not ctx.get("shadow_frame_bytes"):
        return None
    if cells.reader(cells.HERE, "k22_device_ms.shadows")(ctx) is None:
        return None
    inside, _ = tl.inside(lambda n: n == "rtbench.render_frame")
    device_s = sum(op.dur for op in inside) * 1e-6 / ctx["units"]
    if device_s <= 0.0:
        return None
    return 100.0 * ctx["shadow_frame_bytes"] / PEAK_BYTES_PER_S / device_s
