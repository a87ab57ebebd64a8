"""Ablation timing of the differentiable step: the JAX package's
``tools/grads_breakdown.py`` on CUDA events.

    python -m clraytracer_tpu_torch.tools.grads_breakdown [--width 960 --height 540]
        [--iters 4] [--tris N] [--device cpu]

Times the step of ``diff.render_image_diff`` (mean radiance, on the
flagship scene of ``tools/profile_step.py``) forward only, then with
gradients for every leaf group (``diff.DIFF_GROUPS``), then with each of
``tris``, ``atlas``, ``materials`` and ``instances`` detached (its leaves
not ``requires_grad``), to show where the step's time goes. Each row is
the median of ``--iters`` calls, each timed with CUDA events after
``bench.WARMUP`` untimed calls (the host clock with ``--device cpu``);
nothing clamps a time.

The JAX tool also times the forward with its gathers replaced by fakes
(monkeypatched ``take_rgb``/``take_rows``): those measure the TPU's
serialized gathers and are left out here.
"""

from __future__ import annotations

import argparse
import dataclasses
import statistics
import sys

import torch

from clraytracer_tpu_torch import bench
from clraytracer_tpu_torch.device import resolve_device
from clraytracer_tpu_torch.diff import DIFF_GROUPS, grad_leaves, render_image_diff
from clraytracer_tpu_torch.tools.profile_step import flagship_inputs


def grads_with(scene, frame, width: int, height: int, detached: tuple = ()):
    """The step with gradients for every leaf group but ``detached``:
    the loss plus a small multiple of every gradient's sum."""

    def step():
        s, params = grad_leaves(scene)
        s = dataclasses.replace(s, **{g: getattr(scene, g) for g in detached})
        leaves = [v for k, v in params.items() if k.split(".")[0] not in detached]
        loss = torch.mean(render_image_diff(s, frame, width, height, device=s.device))
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return loss + sum(g.sum() for g in grads if g is not None) * 1e-9

    return step


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m clraytracer_tpu_torch.tools.grads_breakdown")
    ap.add_argument("--width", type=int, default=960)
    ap.add_argument("--height", type=int, default=540)
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--tris", type=int, default=4096)
    ap.add_argument("--device", default=None, help="cuda (default) | cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    w, h = args.width, args.height
    scene, frame = flagship_inputs(args.tris, w, h, dev)
    rows = [("fwd only (diff path, no grad)",
             lambda: torch.mean(render_image_diff(scene, frame, w, h, device=dev))),
            ("grads: ALL leaves", grads_with(scene, frame, w, h))]
    rows += [(f"grads: no {g}", grads_with(scene, frame, w, h, (g,))) for g in DIFF_GROUPS]
    clock = (f"CUDA events, {bench.card_line()}" if dev.type == "cuda"
             else "host clock, CPU run")
    print(f"step {w}x{h}, median of {args.iters} after {bench.WARMUP} warm-ups ({clock})")
    for label, fn in rows:
        ms = statistics.median(bench.call_ms(fn, args.iters, dev))
        print(f"{label:40s} {ms:9.3f} ms/step")
    return 0


if __name__ == "__main__":
    sys.exit(main())
