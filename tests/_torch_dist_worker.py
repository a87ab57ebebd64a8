"""One rank of a gloo ``torch.distributed`` run of the port's
multi-device layer, on the CPU or the card. Imports no JAX and nothing of
the JAX package.

Started by ``start`` (tests/test_torch_parallel.py, tests/test_torch_cuda.py;
usable by hand):

    python tests/_torch_dist_worker.py <rank> <world> <rendezvous file> <in.pkl> <out dir>

``in.pkl`` holds the scenes, each as the bridge's (arrays, static) pair
or as ``{"cli": (name, tris)}`` (``cli.build_scene``), the cases to run
and the ``device`` (``"cpu"``, or ``"cuda"``: every rank on the card);
every rank runs every case and writes what it got to
``<out dir>/rank<r>.npz``. Each rank runs one torch thread. The process
group (gloo) fails after ``TIMEOUT_S`` without its ranks.
"""

from __future__ import annotations

import datetime
import os
import pickle
import subprocess
import sys
from pathlib import Path

TIMEOUT_S = 120

CAMERA = (0.13, 0.21, 10.0)
GEO_CAMERA = (0.17, 0.23, 7.0)


def frame_of(w: int, h: int, position=CAMERA, sun: float = -1.96):
    from clraytracer_tpu_torch.camera import Camera
    from clraytracer_tpu_torch.config import CameraConfig
    from clraytracer_tpu_torch.render import frame_inputs_from_camera

    cam = Camera.create(CameraConfig(position=position, yaw_deg=-90.0), w, h)
    return cam, frame_inputs_from_camera(cam, sun)


def rays_of(w: int, h: int, position=GEO_CAMERA):
    """Planar [3, h, w] camera rays (origins, directions) on the CPU."""
    import torch

    from clraytracer_tpu_torch.camera import ray_directions_planar

    cam, _ = frame_of(w, h, position)
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32)
    d = ray_directions_planar(f32(cam.inverse_view), f32(cam.inverse_projection), w, h)
    o = f32(cam.position)[:, None, None].expand(d.shape)
    return o, d


def run_case(case: dict, scenes: dict, dev) -> dict:
    """One case on this rank → {name: numpy array}."""
    import numpy as np
    import torch

    from clraytracer_tpu_torch.config import RenderConfig
    from clraytracer_tpu_torch.parallel import geometry as geo
    from clraytracer_tpu_torch.parallel import sharding as sh
    from clraytracer_tpu_torch.render import TRACERS

    kind, name = case["kind"], case["name"]
    scene = scenes[case["scene"]]
    out = {}
    if kind == "render":
        w, h = case["wh"]
        mesh = sh.make_device_mesh(device=dev)
        scene = sh.replicate_scene(scene, mesh)
        _, frame = frame_of(w, h, case.get("camera", CAMERA))
        img = sh.render_sharded(scene, frame, RenderConfig(width=w, height=h), mesh,
                                tracer=TRACERS[case["tracer"]])
        out[name] = img.cpu().numpy()
    elif kind == "train":
        w, h = case["wh"]
        mesh = sh.make_device_mesh(device=dev)
        _, frame = frame_of(w, h)
        loss, new = sh.train_step_sharded(
            scene, frame, torch.from_numpy(case["target"]), mesh, lr=case["lr"],
            base_tracer=TRACERS[case["tracer"]])
        out[name + ".loss"] = np.asarray(float(loss))
        out[name + ".albedo"] = new.materials.albedo.cpu().numpy()
    elif kind == "geo_trace":
        o, d = (x.to(dev) for x in rays_of(*case["wh"]))
        hit = geo.make_geo_sharded_tracer(sh.make_device_mesh(device=dev))(scene, o, d)
        for f in ("t", "u", "v", "tri", "instance", "hit"):
            out[f"{name}.{f}"] = getattr(hit, f).cpu().numpy()
    elif kind in ("render_2d", "train_2d"):
        w, h = case["wh"]
        mesh = geo.make_mesh_2d(*case["mesh"], device=dev)
        _, frame = frame_of(w, h, GEO_CAMERA, case.get("sun", -1.96))
        if kind == "render_2d":
            img = geo.render_sharded_2d(scene, frame, RenderConfig(width=w, height=h), mesh)
            out[name] = img.cpu().numpy()
        else:
            loss, new = geo.train_step_sharded_2d(
                scene, frame, torch.from_numpy(case["target"]), mesh, lr=case["lr"])
            out[name + ".loss"] = np.asarray(float(loss))
            out[name + ".albedo"] = new.materials.albedo.cpu().numpy()
    else:
        raise SystemExit(f"unknown case kind {kind}")
    return out


def start(world: int, d: Path, spec: dict) -> list:
    """``world`` ranks of this script as processes, their rendezvous and
    results in directory ``d``, ``spec`` as ``in.pkl``."""
    with open(d / "in.pkl", "wb") as f:
        pickle.dump(spec, f)
    root = Path(__file__).resolve().parent.parent
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = str(root) + (os.pathsep + env["PYTHONPATH"]
                                      if env.get("PYTHONPATH") else "")
    return [
        subprocess.Popen(
            [sys.executable, __file__, str(r), str(world), str(d / "rdv"),
             str(d / "in.pkl"), str(d)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        )
        for r in range(world)
    ]


def wait(procs: list, d: Path, timeout: float) -> list[dict]:
    """Each rank's arrays, once every rank of ``procs`` (from ``start``)
    has exited 0 within ``timeout`` seconds; otherwise every rank is
    killed and the ranks' errors raised."""
    import numpy as np

    errs = []
    try:
        for r, p in enumerate(procs):
            _, err = p.communicate(timeout=timeout)
            if p.returncode != 0:
                errs.append(f"rank {r}: {err.decode()[-3000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    if errs:
        raise AssertionError("\n".join(errs))
    return [dict(np.load(d / f"rank{r}.npz")) for r in range(len(procs))]


def main() -> None:
    rank, world = int(sys.argv[1]), int(sys.argv[2])
    rdv, inp, out_dir = sys.argv[3], Path(sys.argv[4]), Path(sys.argv[5])

    import numpy as np
    import torch
    import torch.distributed as dist

    from clraytracer_tpu_torch.cli import build_scene
    from clraytracer_tpu_torch.scene.bridge import scene_from_numpy

    torch.set_num_threads(1)
    with open(inp, "rb") as f:
        spec = pickle.load(f)
    dev = spec.get("device", "cpu")
    if dev == "cuda":
        torch.cuda.set_device(0)
    scenes = {k: build_scene(*v["cli"], device=dev) if isinstance(v, dict)
              else scene_from_numpy(*v, device=dev) for k, v in spec["scenes"].items()}
    dist.init_process_group("gloo", init_method=f"file://{rdv}", world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=TIMEOUT_S))
    got = {}
    for case in spec["cases"]:
        got.update(run_case(case, scenes, dev))
    dist.barrier()
    dist.destroy_process_group()
    np.savez(out_dir / f"rank{rank}.npz", **got)


if __name__ == "__main__":
    main()
