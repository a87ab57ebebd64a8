"""Entry points of the port (the JAX package's ``__graft_entry__.py``).

``entry()``            — the single-card forward frame on the flagship scene:
                         ``render.render_frame`` at 256x192, on the card one
                         launch of the fused frame kernel (K2.2).
``dryrun_multichip(n)``— the multi-device path over a world of n ranks at
                         tiny shapes: ``render_sharded``, one
                         ``train_step_sharded`` and, for even n,
                         ``render_sharded_2d`` on an (n/2) x 2 mesh.

The JAX function runs one process over n devices; here the ranks are
started by the function itself. On the card a world of one is an NCCL
group in this process, and a larger world is gloo processes sharing card 0
(NCCL takes one rank per card); on the CPU it is gloo. Self-test:

    python -m clraytracer_tpu_torch.entry [--device cpu] [--n N]
"""

from __future__ import annotations

import argparse
import sys
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from clraytracer_tpu_torch.camera import Camera
from clraytracer_tpu_torch.config import CameraConfig, RenderConfig
from clraytracer_tpu_torch.device import resolve_device
from clraytracer_tpu_torch.parallel.geometry import make_mesh_2d, render_sharded_2d
from clraytracer_tpu_torch.parallel.launch import run_ranks
from clraytracer_tpu_torch.parallel.sharding import (
    INIT_TIMEOUT,
    make_device_mesh,
    render_sharded,
    replicate_scene,
    train_step_sharded,
)
from clraytracer_tpu_torch.render import FrameInputs, frame_inputs_from_camera, render_frame
from clraytracer_tpu_torch.scene import SceneBuilder
from clraytracer_tpu_torch.scene import procedural_tex as ptex
from clraytracer_tpu_torch.scene.procedural import uv_sphere

CAMERA = (0.13, 0.21, 10.0)
SUN = -1.96
ENTRY_WH = (256, 192)
#: the dry run's frame: this width, and this many rows a rank
DRYRUN_WIDTH, DRYRUN_ROWS = 32, 4


def _flagship_scene(n_lat: int = 16, n_lon: int = 32,
                    device: str | torch.device | None = None):
    """The BASELINE config-1 scene: textured UV sphere + equirect sky."""
    b = SceneBuilder()
    b.import_procedural(ptex.sky_gradient(256, 128))
    checker = b.import_procedural(ptex.checker(64, 8))
    mat = b.create_material(
        albedo=(0.9, 0.6, 0.3), albedo_tex=checker, shininess=1.0, roughness=0.4
    )
    mesh = b.add_mesh(uv_sphere(2.0, n_lat=n_lat, n_lon=n_lon), materials_start=mat)
    b.add_instance(mesh)
    return b.build(device=device)


def _frame(width: int, height: int, device: torch.device) -> FrameInputs:
    cam = Camera.create(CameraConfig(position=CAMERA), width, height)
    return FrameInputs(*(x.to(device) for x in frame_inputs_from_camera(cam, SUN)))


def entry(device: str | torch.device | None = None):
    """Returns ``(fn, (scene, frame))``: ``fn(scene, frame)`` is the
    default frame (``render_frame`` with the default ``RenderConfig``) at
    256x192 on the scene's device (None = the CUDA card)."""
    dev = resolve_device(device)
    width, height = ENTRY_WH
    scene = _flagship_scene(device=dev)
    frame = _frame(width, height, dev)
    config = RenderConfig(width=width, height=height)

    def fn(scene, frame):
        return render_frame(scene, frame, config, device=scene.device)

    return fn, (scene, frame)


def _check_finite(name: str, x: torch.Tensor, shape: tuple | None = None) -> None:
    if shape is not None and tuple(x.shape) != shape:
        raise RuntimeError(f"{name}: shape {tuple(x.shape)}, expected {shape}")
    if not bool(torch.isfinite(x).all()):
        raise RuntimeError(f"{name}: not finite")


def _dryrun_rank(n_devices: int, device: str) -> float:
    """This rank's part of the dry run (the default group holds the
    world, or no group a world of one) → the step's loss."""
    dev = torch.device("cuda", 0) if device == "cuda" else torch.device(device)
    mesh = make_device_mesh(device=dev)
    width, height = DRYRUN_WIDTH, DRYRUN_ROWS * n_devices
    scene = replicate_scene(_flagship_scene(n_lat=6, n_lon=8, device=dev), mesh)
    frame = _frame(width, height, dev)
    # forward (inference) path, row-sharded
    img = render_sharded(scene, frame, RenderConfig(width=width, height=height), mesh)
    _check_finite("render_sharded", img, (height, width, 3))
    # the training step: forward, backward, all-reduce, update
    target = np.random.default_rng(0).uniform(0, 1, (height, width, 3)).astype(np.float32)
    loss, new_scene = train_step_sharded(scene, frame, torch.from_numpy(target).to(dev),
                                         mesh, lr=1e-2)
    _check_finite("loss", loss)
    _check_finite("albedo", new_scene.materials.albedo)
    # rows over the row axis, instances over the geo axis
    if n_devices % 2 == 0:
        mesh2 = make_mesh_2d(n_devices // 2, 2, device=dev)
        h2 = DRYRUN_ROWS * (n_devices // 2)
        img2 = render_sharded_2d(scene, _frame(width, h2, dev),
                                 RenderConfig(width=width, height=h2), mesh2)
        _check_finite("render_sharded_2d", img2, (h2, width, 3))
    return float(loss)


def dryrun_multichip(n_devices: int, device: str | torch.device | None = None) -> float:
    """One sharded forward frame and one sharded training step over a
    world of ``n_devices`` ranks at tiny shapes (width 32, 4 rows a rank,
    the flagship scene at 6 x 8), and for even n the 2-D mesh's frame;
    prints ``dryrun_multichip(n): ok, loss=...`` and returns the loss.

    On the card (None) a world of one is an NCCL group in this process and
    a larger one gloo processes sharing card 0, started after this
    process has built the kernels; with ``device="cpu"`` the ranks are
    gloo. A rank that fails, or a world that outlasts its timeout, raises
    RuntimeError."""
    if n_devices < 1:
        raise ValueError("n_devices must be at least 1")
    dev = resolve_device(device)
    if n_devices == 1:
        if dist.is_initialized():
            raise RuntimeError("dryrun_multichip starts its own process group; "
                               "destroy the caller's first")
        backend, extra = ("nccl", {"device_id": torch.device("cuda", 0)}) \
            if dev.type == "cuda" else ("gloo", {})
        with tempfile.TemporaryDirectory() as tmp:
            dist.init_process_group(backend, init_method=f"file://{tmp}/rdv", world_size=1,
                                    rank=0, timeout=INIT_TIMEOUT, **extra)
            try:
                loss = _dryrun_rank(1, dev.type)
            finally:
                dist.destroy_process_group()
    else:
        if dev.type == "cuda":
            from clraytracer_tpu_torch.runtime import kernels

            kernels.build_all()
        losses = run_ranks(_dryrun_rank, n_devices, (n_devices, dev.type), dev.type)
        if len(set(losses)) != 1:
            raise RuntimeError(f"the ranks' losses differ: {losses}")
        loss = losses[0]
    print(f"dryrun_multichip({n_devices}): ok, loss={loss:.5f}")
    return loss


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m clraytracer_tpu_torch.entry")
    ap.add_argument("--device", default=None, help="cuda (default) | cpu")
    ap.add_argument("--n", type=int, default=2, help="ranks of the dry run")
    args = ap.parse_args(argv)
    fn, fn_args = entry(args.device)
    out = fn(*fn_args)
    _check_finite("entry", out, ENTRY_WH[::-1] + (3,))
    print("entry ok:", tuple(out.shape))
    dryrun_multichip(args.n, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
