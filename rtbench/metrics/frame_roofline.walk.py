"""The frame's share of its bandwidth roofline, in %: the bytes the
frame's inputs need (``rtbench.roofline``) at the card's peak bandwidth,
over the device time of every kernel, copy and fill launched inside
``render_frame`` (a pick's K2.1 is outside it)."""

from rtbench.roofline import PEAK_BYTES_PER_S


def read(ctx):
    tl = ctx.get("timeline")
    if tl is None or ctx.get("kind") != "frames" or not ctx.get("frame_bytes"):
        return None
    inside, _ = tl.inside(lambda n: n == "rtbench.render_frame")
    device_s = sum(op.dur for op in inside) * 1e-6 / ctx["units"]
    if device_s <= 0.0:
        return None
    return 100.0 * ctx["frame_bytes"] / PEAK_BYTES_PER_S / device_s
