"""Device ms a frame of K2.2 in the 401-instance cell: the reader of
``k22_device_ms.walk``, whose K2.2 here walks every instance on each ray."""

from rtbench import cells


def read(ctx):
    return cells.reader(cells.HERE, "k22_device_ms.walk")(ctx)
