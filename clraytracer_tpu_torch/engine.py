"""Engine: the frame loop (the JAX package's ``engine.py``; the
reference's Engine.cpp/Engine.hpp).

* ``Engine`` owns a SceneBuilder (or a built scene), a Camera and the
  per-frame state: ``start`` builds the scene on the engine's device
  (Engine_Start, Engine.cpp:56-80), ``tick`` applies instance-transform
  edits (Engine_Tick, Engine.cpp:82-128), ``render`` renders the frame
  through ``render.render_frame``, ``end_frame`` drains the deferred events
  (Engine_EndFrame, Engine.cpp:130-134) and ``pick`` raycasts a mouse
  position through the engine's tracer (Engine.cpp:112-126).
* **End-of-frame events** (Engine_AddEndOfFrameEvent, Engine.cpp:13-20)
  run after the frame in flight; **exit events** (Engine_AddOnExitEvent,
  Engine.cpp:22-28) on ``close``.
* **Instance edits**: ``set_instance_transform`` inverts the edited
  instance's transform into the builder's kept table (SetMeshMatrix,
  Renderer.cpp:288-298) and marks the instance table dirty; the next
  ``tick`` uploads the kept instance rows once (the dirty-range upload,
  Renderer.cpp:312-320) and replaces the instance rows and world boxes
  alone (``ops.trace.with_instances``); the other tables stay.
* **Frames**: ``render`` hands ``render_frame`` a ``render.CameraFrame``
  (the camera, the sun and the projection's inverse, kept for the camera's
  configuration and size); on the card its frame plan
  (``render_fused.render_plan``) takes the kernel's camera row from it.
* **Profiler stats** go to ``utils.timer.profiler_stats``
  (Engine_UpdateProfilerStats, Engine.cpp:36-51): the spans ``engine.start``,
  ``engine.tick`` (``engine.instances`` then ``tables.instances`` inside it),
  ``engine.render`` (``engine.wait`` inside it: the watchdog's synchronise
  on the card) and ``engine.pick``, one ``engine.inverse`` an instance
  transform inverted (the builder's, at ``add_instance`` and
  ``set_instance_transform``), and the spans of the layers below them
  (``tables.*``, ``render.*``, ``pick.*``).

The device is the CUDA card unless the caller passes ``device="cpu"``;
without a card, ``device=None`` raises.
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch

from clraytracer_tpu_torch.camera import Camera
from clraytracer_tpu_torch.config import CameraConfig, RenderConfig
from clraytracer_tpu_torch.device import resolve_device
from clraytracer_tpu_torch.ops.trace import with_instances
from clraytracer_tpu_torch.raycast import HitRecord, pick
from clraytracer_tpu_torch.render import TRACERS, CameraFrame, render_frame
from clraytracer_tpu_torch.scene.builder import SceneBuilder
from clraytracer_tpu_torch.scene.types import Scene
from clraytracer_tpu_torch.utils.timer import ScopeTimer, profiler_stats

#: frames exempt from the watchdog: the first two carry the kernels' load
#: and their first launch (the JAX package's compiles)
WATCHDOG_WARMUP = 2


class FrameWatchdogError(RuntimeError):
    """A frame past the warm-up took longer than
    ``RenderConfig.frame_watchdog_ms`` (reference Renderer.cpp:370-371)."""


class Engine:
    """Frame-loop orchestration over a built scene."""

    def __init__(
        self,
        builder: SceneBuilder | None = None,
        config: RenderConfig = RenderConfig(),
        camera_config: CameraConfig | None = None,
        tracer: str = "best",
        scene: Scene | None = None,
        device: str | torch.device | None = None,
    ) -> None:
        """Give a ``builder`` (``start()`` builds and uploads) or a built
        ``scene`` on ``device``. ``tracer`` names one of
        ``render.TRACERS``."""
        if builder is None and scene is None:
            raise ValueError("Engine needs a builder or a scene")
        if tracer not in TRACERS:
            raise ValueError(f"tracer '{tracer}' is not one of {', '.join(TRACERS)}")
        self.device = resolve_device(device)
        if scene is not None and scene.device.type != self.device.type:
            raise ValueError(f"scene is on {scene.device}, the engine on {self.device}")
        self.builder = builder
        self.config = config
        self.tracer = tracer
        self.camera = Camera.create(
            camera_config or CameraConfig(), config.width, config.height
        )
        self.scene: Scene | None = scene
        self.sun_angle = float(config.sun_angle)
        self.frame_index = 0
        self._end_of_frame: list[Callable[[], None]] = []
        self._on_exit: list[Callable[[], None]] = []
        self._instances_dirty = False
        #: (camera config, width, height, its projection's inverse [16] f32)
        self._projection = None
        #: the watchdog's two CUDA events, reused by every frame
        self._events = None

    # -- events (Engine.cpp:13-28) -------------------------------------------

    def add_end_of_frame_event(self, fn: Callable[[], None]) -> None:
        self._end_of_frame.append(fn)

    def add_on_exit_event(self, fn: Callable[[], None]) -> None:
        self._on_exit.append(fn)

    # -- lifecycle ------------------------------------------------------------

    def start(self) -> Scene:
        """Build and upload the scene (Engine_Start → PushMeshesToGPU)."""
        with ScopeTimer("engine.start"):
            self.scene = self.builder.build(device=self.device)
        return self.scene

    def set_instance_transform(self, handle: int, transform: np.ndarray) -> None:
        """SetMeshMatrix equivalent: takes effect at the next ``tick``."""
        self.builder.set_instance_transform(handle, transform)
        self._instances_dirty = True

    def update_camera(self, **kwargs) -> None:
        self.camera = self.camera.updated(**kwargs)

    def tick(self, dt: float = 1.0 / 60.0) -> None:
        """Per-frame update: upload the edited instance rows and replace
        the rows and boxes that track them (``ops.trace.with_instances``)."""
        with ScopeTimer("engine.tick", log=False):
            if self._instances_dirty and self.scene is not None:
                with ScopeTimer("engine.instances", log=False):
                    rows = self.builder.instance_rows(device=self.device)
                self.scene = with_instances(self.scene, rows, self.builder.mesh_index)
                self._instances_dirty = False

    def _frame(self) -> CameraFrame:
        """The frame's inputs: the camera as it stands, the projection's
        inverse kept while its configuration and size stay."""
        cam, kept = self.camera, self._projection
        if kept is None or not (kept[0] is cam.config and kept[1] == cam.width
                                and kept[2] == cam.height):
            kept = self._projection = (cam.config, cam.width, cam.height,
                                       cam.inverse_projection.reshape(16))
        return CameraFrame(cam, self.sun_angle, kept[3])

    def render(self) -> torch.Tensor:
        """The current frame, [H, W, 3] on the engine's device
        (Renderer::Render).

        With ``config.frame_watchdog_ms`` set the frame is timed on the
        card (CUDA events around it, the stream synchronised after it; the
        host clock on the CPU), and a frame past the first
        ``WATCHDOG_WARMUP`` over the budget raises
        :class:`FrameWatchdogError`: the reference's 80 ms "GPU
        Bottleneck!" watchdog (Renderer.cpp:370-371), raising instead of
        ``exit(0)``."""
        if self.scene is None:
            raise RuntimeError("call start() first")
        budget = self.config.frame_watchdog_ms
        tracer = TRACERS[self.tracer]
        cuda = self.device.type == "cuda"
        with ScopeTimer("engine.render", log=False):
            frame = self._frame()
            if budget is None:
                img = render_frame(self.scene, frame, self.config, self.device, tracer)
            elif cuda:
                if self._events is None:
                    self._events = (torch.cuda.Event(enable_timing=True),
                                    torch.cuda.Event(enable_timing=True))
                start, end = self._events
                start.record()
                img = render_frame(self.scene, frame, self.config, self.device, tracer)
                end.record()
                with ScopeTimer("engine.wait", log=False):
                    end.synchronize()
                dt_ms = start.elapsed_time(end)
            else:
                t0 = time.perf_counter()
                img = render_frame(self.scene, frame, self.config, self.device, tracer)
                dt_ms = (time.perf_counter() - t0) * 1e3
        if budget is not None and self.frame_index >= WATCHDOG_WARMUP and dt_ms > budget:
            raise FrameWatchdogError(
                f"frame {self.frame_index} took {dt_ms:.1f} ms (watchdog {budget:.1f} ms)"
            )
        self.frame_index += 1
        return img

    def pick(self, x: float, y: float) -> HitRecord:
        """Raycast the screen point (x, y) of the current camera through the
        engine's tracer (Engine.cpp:112-126): host numpy values."""
        if self.scene is None:
            raise RuntimeError("call start() first")
        with ScopeTimer("engine.pick", log=False):
            return pick(self.scene, self.camera, x, y, TRACERS[self.tracer])

    def end_frame(self) -> None:
        """Drain the deferred events (Engine_EndFrame, Engine.cpp:130-134)."""
        events, self._end_of_frame = self._end_of_frame, []
        for fn in events:
            fn()

    def close(self) -> None:
        """Run the exit events (Engine_Exit, Engine.cpp:136-140)."""
        events, self._on_exit = self._on_exit, []
        for fn in events:
            fn()

    @property
    def stats(self) -> dict[str, float]:
        return dict(profiler_stats)
