"""The comparison that decides ``correct``: the program's answers against
the plain reference's, each compared number beside its limit.

Frames: a sample of pixels of a sample of the window's frames, drawn from
the seed, and a sample of its picks. Steps: a sample of the window's steps,
their loss and the norm of every leaf's gradient.
"""

from __future__ import annotations

import json
import statistics
from pathlib import Path

import numpy as np
import torch

#: a pixel whose colour differs from the reference's by more than this in
#: some channel (the image's [0, 1] scale; 5/255 is about 0.02) counts as off
PX_TOL = 0.02
#: a pick disagrees where its hit or instance differs, or, on a hit, its
#: distance by more than this share, its colour by more than 1.5/255, or its
#: normal or uv by more than 1e-2
PICK_DIST_TOL = 1e-3
PICK_COLOR_TOL = 1.5 / 255.0
PICK_VEC_TOL = 1e-2
#: leaves whose reference gradient norm is under this share of the median
#: leaf's are nought to rounding: they are compared as strays, not by gap
ZERO_LEAF = 1e-3


def limits(root: Path, cell: str) -> dict:
    """The cell's limits, ``rtbench/limits/<cell>.json``: {number: limit}."""
    return json.loads((root / "limits" / f"{cell}.json").read_text())["limits"]


def pixels_off(port: torch.Tensor, ref: torch.Tensor) -> float:
    """Share of pixels [n, 3] off by more than ``PX_TOL`` (or not finite)."""
    gap = (port.float() - ref.float()).abs().amax(dim=1)
    bad = ~(gap <= PX_TOL)
    return float(bad.float().mean())


def pick_disagrees(port, ref: dict) -> bool:
    """Does the program's hit record (raycast.HitRecord of numpy values)
    disagree with the reference's?"""
    if bool(port.hit) != ref["hit"]:
        return True
    if not ref["hit"]:
        return False
    if int(port.instance) != ref["instance"]:
        return True
    d = float(port.distance)
    if not abs(d - ref["distance"]) <= PICK_DIST_TOL * max(1.0, abs(ref["distance"])):
        return True
    if not np.all(np.abs(np.asarray(port.color, np.float64) - ref["color"]) <= PICK_COLOR_TOL):
        return True
    for a, b in ((port.normal, ref["normal"]), (port.uv, ref["uv"])):
        if not np.all(np.abs(np.asarray(a, np.float64) - b) <= PICK_VEC_TOL):
            return True
    return False


def leaf_norm(g: torch.Tensor) -> float:
    """The norm of a gradient, every element in it."""
    return float(g.detach().float().norm())


def nonzero_median(norms: dict) -> float:
    """The median of the nonzero norms (1 where there is none)."""
    nonzero = [v for v in norms.values() if v > 0.0]
    return statistics.median(nonzero) if nonzero else 1.0


def leaf_gaps(port_norms: dict, ref_norms: dict) -> tuple[float, float, list[str]]:
    """(worst gap of norms, worst stray, leaves excluded) of one step.

    A leaf is compared where the reference's gradient norm is at least
    ``ZERO_LEAF`` of the median of its nonzero leaves: the gap of the two
    norms, over the larger of the reference's norm and that median. The
    others, and the program's leaves the reference does not have (the
    tables only the traversal reads), are strays: their norm over the
    median, which should be nought."""
    med = nonzero_median(ref_norms)
    gap, stray, out = 0.0, 0.0, []
    for k, pn in port_norms.items():
        rn = ref_norms.get(k)
        if rn is None or rn < ZERO_LEAF * med:
            out.append(k)
            s = pn / med if np.isfinite(pn) else float("inf")
            stray = max(stray, s)
            continue
        g = abs(pn - rn) / max(rn, med) if np.isfinite(pn) else float("inf")
        gap = max(gap, g)
    missing = [k for k in ref_norms if k not in port_norms]
    if missing:
        gap = float("inf")
    return gap, stray, out


def verdict(numbers: dict, lim: dict) -> tuple[bool, dict]:
    """``correct`` and {number: {"value", "limit"}}: every number at most
    its limit (a number that is not finite fails)."""
    shown = {k: {"value": v, "limit": lim[k]} for k, v in numbers.items()}
    ok = all(np.isfinite(v) and v <= lim[k] for k, v in numbers.items())
    return bool(ok), shown
