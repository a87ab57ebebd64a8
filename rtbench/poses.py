"""Camera paths: a fixed closed path of poses for a configuration's
``path``, and the seed's place on it.

Every seed walks the same poses, from another start: the set of poses, and
so the work of a window, is the same for every seed.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np


class Pose(NamedTuple):
    position: tuple  # (x, y, z)
    yaw_deg: float
    pitch_deg: float


def _look(position, target) -> Pose:
    d = np.asarray(target, np.float64) - np.asarray(position, np.float64)
    d /= np.linalg.norm(d)
    return Pose(tuple(float(x) for x in position), math.degrees(math.atan2(d[2], d[0])),
                math.degrees(math.asin(d[1])))


def _span(lo_hi, s: float) -> float:
    """``lo_hi`` [lo, hi] at s in [-1, 1]."""
    lo, hi = lo_hi
    return 0.5 * (lo + hi) + 0.5 * (hi - lo) * s


def path(spec: dict, n: int) -> list[Pose]:
    """The ``n`` poses of the closed path ``spec``.

    ``orbit``: at ``distance`` from ``center``, once around it, the height
    over the centre swinging over ``height`` three times a turn, looking at
    the centre. ``sweep``: a closed figure of eight of half-widths
    ``radius`` (x, z) about ``center``, the height, yaw and pitch each
    swinging over its range at its own rate."""
    poses = []
    for k in range(n):
        a = 2.0 * math.pi * k / n
        if spec["kind"] == "orbit":
            c = spec["center"]
            h = _span(spec["height"], math.sin(3.0 * a))
            r = math.sqrt(spec["distance"] ** 2 - h * h)
            pos = (c[0] + r * math.cos(a), c[1] + h, c[2] + r * math.sin(a))
            poses.append(_look(pos, c))
        elif spec["kind"] == "sweep":
            c, (rx, rz) = spec["center"], spec["radius"]
            pos = (c[0] + rx * math.sin(a), _span(spec["height"], math.sin(3.0 * a + 0.5)),
                   c[2] + rz * math.sin(2.0 * a))
            poses.append(Pose(pos, _span(spec["yaw"], math.sin(a + 1.0)),
                              _span(spec["pitch"], math.sin(5.0 * a))))
        else:
            raise ValueError(f"unknown camera path kind {spec['kind']!r}")
    return poses


def start(seed: int, n: int) -> int:
    """The seed's first pose on a path of ``n``."""
    return int(np.random.default_rng([seed, 1]).integers(n))
