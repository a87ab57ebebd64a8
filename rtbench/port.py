"""The system under test: ``clraytracer_tpu_torch`` driven through its
public entries (``SceneBuilder``, ``engine.Engine``, ``diff``), and the
benchmark's spans around those calls in a traced run.

Nothing else of the benchmark imports the program.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from rtbench.poses import Pose
from rtbench.scenes.spec import SceneSpec


def builder(spec: SceneSpec):
    """The program's ``SceneBuilder`` holding ``spec``: every handle it
    returns is the spec's own index."""
    from clraytracer_tpu_torch.config import PoolConfig
    from clraytracer_tpu_torch.scene import SceneBuilder
    from clraytracer_tpu_torch.scene import procedural_tex as ptex
    from clraytracer_tpu_torch.scene.procedural import MeshData

    b = SceneBuilder(PoolConfig(max_textures=spec.max_textures))
    for handle, tex in enumerate(spec.textures[2:], start=2):
        got = (b.import_procedural(ptex.ProceduralTexture(**tex.procedural))
               if tex.procedural is not None else b.import_texture(tex.image))
        if got != handle:
            raise RuntimeError(f"texture {handle} became handle {got}")
    for handle, m in enumerate(spec.materials[1:], start=1):
        got = b.create_material(albedo=m.albedo, specular=m.specular, albedo_tex=m.albedo_tex,
                                specular_tex=m.specular_tex, shininess=m.shininess,
                                roughness=m.roughness)
        if got != handle:
            raise RuntimeError(f"material {handle} became handle {got}")
    for mesh in spec.meshes:
        b.add_mesh(MeshData(v0=mesh.v0, v1=mesh.v1, v2=mesh.v2, uv0=mesh.uv0, uv1=mesh.uv1,
                            uv2=mesh.uv2, n0=mesh.n0, n1=mesh.n1, n2=mesh.n2, mat_idx=mesh.mat))
    for inst in spec.instances:
        b.add_instance(inst.mesh, inst.transform, inst.material_start)
    return b


def render_config(config: dict, watchdog_ms: float | None = None):
    """The frame loop's ``RenderConfig``: the configuration's sizes, and the
    options under its ``render`` key as they stand."""
    from clraytracer_tpu_torch.config import RenderConfig

    return RenderConfig(width=int(config["width"]), height=int(config["height"]),
                        bounces=int(config["bounces"]), sun_angle=float(config["sun_angle"]),
                        frame_watchdog_ms=watchdog_ms, **config.get("render", {}))


def engine(spec: SceneSpec, config: dict, device: torch.device, watchdog_ms: float | None):
    """A started ``Engine`` over ``spec`` (the program's build and upload)."""
    from clraytracer_tpu_torch.engine import Engine

    eng = Engine(builder(spec), render_config(config, watchdog_ms), device=device)
    eng.start()
    return eng


def set_pose(eng, pose: Pose) -> None:
    eng.camera = dataclasses.replace(eng.camera, position=np.asarray(pose.position, np.float32),
                                     yaw_deg=pose.yaw_deg, pitch_deg=pose.pitch_deg)


def frame_inputs(config: dict, pose: Pose, device: torch.device):
    """The program's per-frame inputs of ``pose`` on ``device``."""
    from clraytracer_tpu_torch.camera import Camera
    from clraytracer_tpu_torch.config import CameraConfig
    from clraytracer_tpu_torch.render import FrameInputs, frame_inputs_from_camera

    cam = Camera.create(CameraConfig(position=pose.position, yaw_deg=pose.yaw_deg,
                                     pitch_deg=pose.pitch_deg),
                        int(config["width"]), int(config["height"]))
    f = frame_inputs_from_camera(cam, float(config["sun_angle"]))
    return FrameInputs(*(x.to(device) for x in f))


def step(scene, frame, config: dict, target: torch.Tensor, device: torch.device):
    """One differentiable step → (loss, {leaf: gradient})."""
    from clraytracer_tpu_torch.diff import image_loss_and_grads

    return image_loss_and_grads(scene, frame, int(config["width"]), int(config["height"]),
                                target=target, device=device, bounces=int(config["bounces"]))


class Spans:
    """Host seconds of the benchmark's spans around the program's calls,
    and a ``record_function`` range of the same name for the profiler:
    ``engine.render_frame`` is timed by standing a wrapper in for the name
    the engine calls while the ``with`` block runs."""

    def __init__(self) -> None:
        self.seconds: dict[str, list[float]] = {}
        self.returned = 0.0  # perf_counter when the last wrapped call returned
        self._undo = []

    def add(self, name: str, seconds: float) -> None:
        self.seconds.setdefault(name, []).append(seconds)

    def wrap(self, module, attr: str, name: str) -> None:
        real = getattr(module, attr)

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            with torch.profiler.record_function(name):
                out = real(*args, **kwargs)
            self.returned = time.perf_counter()
            self.add(name, self.returned - t0)
            return out

        setattr(module, attr, timed)
        self._undo.append((module, attr, real))

    def __enter__(self):
        from clraytracer_tpu_torch import engine as engine_mod

        self.wrap(engine_mod, "render_frame", "rtbench.render_frame")
        return self

    def __exit__(self, *exc) -> None:
        for module, attr, real in reversed(self._undo):
            setattr(module, attr, real)
        self._undo.clear()
