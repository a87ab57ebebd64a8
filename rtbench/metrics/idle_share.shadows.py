"""The share of the traced window, in %, in which no kernel, copy or fill
ran on the card, in the shadowed museum's cell: the reader of
``idle_share.walk``."""

from rtbench import cells


def read(ctx):
    return cells.reader(cells.HERE, "idle_share.walk")(ctx)
