"""The frame pipeline: trace and shade → post chain, on two paths.

``render_frame`` (render.py:503 of the JAX package) renders every frame
the JAX ``render_frame`` renders. A frame the fused kernel covers
(reference-parity integer-colour Phong, no refraction, at most 64
materials when every texture is procedural) is one launch of K2.2 in
camera mode per frame (per sample), then the deferred texels and sky and
the post chain. Every other frame (refraction, material shading, float
colours, all-procedural scenes of more materials) takes the two-phase
path: ``bounce_loop`` traces each bounce with K2.1 (``ops.trace.trace``)
and shades it in torch (``ops.shade.shade_hits``), sun-shadow rays
through K2.1 too. On a CPU scene the kernels are their plain versions.

``trace_planar``/``bounce_loop`` (render.py:102-326 of the JAX package)
take any tracer: given K2.1's, a frame the fused kernel covers is one
launch of K2.2 in ray mode (``render_fused.render_fused``);
``diff.render_image_diff`` passes its differentiable tracer.

The frame entries take a ``tracer`` (``TRACERS`` by name, as the JAX
CLI's ``--tracer``). The default, ``trace_best``, takes the kernels
whenever the scene has cluster tables, and the reference tracers'
``trace_wavefront`` (plain torch) on a scene without them. Any other
tracer renders the two-phase path with it.
"""

from __future__ import annotations

import struct
import zlib
from typing import Callable, NamedTuple

import numpy as np
import torch

from clraytracer_tpu_torch.camera import Camera, ray_directions_tiled
from clraytracer_tpu_torch.config import RenderConfig
from clraytracer_tpu_torch.device import resolve_device
from clraytracer_tpu_torch.ops import gather, rng
from clraytracer_tpu_torch.ops import render_fused as rf
from clraytracer_tpu_torch.ops.post import post_process
from clraytracer_tpu_torch.ops.shade import initial_bounce_state, shade_hits
from clraytracer_tpu_torch.ops.trace import SceneHit, trace
from clraytracer_tpu_torch.ops.trace_ref import trace_brute, trace_bvh
from clraytracer_tpu_torch.ops.trace_wavefront import trace_wavefront
from clraytracer_tpu_torch.scene.types import Scene
from clraytracer_tpu_torch.utils.timer import ScopeTimer

#: A tracer maps (scene, origins [3, ...], directions [3, ...], live=None)
#: → SceneHit with [...]-shaped fields; ``live`` is a [...] bool mask of the
#: rays still bouncing, or None on bounce 0.
Tracer = Callable[..., SceneHit]


def trace_best(scene: Scene, origin, direction, **kw) -> SceneHit:
    """The tracer for this scene (``resolve_tracer``): K2.1 when the scene
    has cluster tables, else ``trace_wavefront``. The default everywhere."""
    return resolve_tracer(trace_best, scene)(scene, origin, direction, **kw)


def resolve_tracer(tracer: Tracer, scene: Scene) -> Tracer:
    """``trace_best`` resolved against the scene (its cluster tables are a
    static property of a built scene, as in render.py:55-61 of the JAX
    package); any other tracer as given."""
    if tracer is trace_best:
        return trace if scene.clusters is not None else trace_wavefront
    return tracer


#: tracers by name, the JAX CLI's ``--tracer`` choices; ``"pallas"`` names
#: the port's K2.1 (``ops.trace.trace``), so a JAX command line carries over
TRACERS: dict[str, Tracer] = {
    "best": trace_best,
    "brute": trace_brute,
    "bvh": trace_bvh,
    "wavefront": trace_wavefront,
    "pallas": trace,
}


def register_tracer(name: str, fn: Tracer) -> None:
    TRACERS[name] = fn


#: test hook: False makes the float path of imported-texture scenes gather
#: its texels in every bounce instead of once after the loop
_DEFER_TEXELS = True


class FrameInputs(NamedTuple):
    """Per-frame inputs (the reference's TraceArgs + matrices). Host-side
    f32 tensors: the kernel takes them as launch parameters."""

    inverse_view: torch.Tensor  # [4, 4]
    inverse_projection: torch.Tensor  # [4, 4]
    camera_position: torch.Tensor  # [3]
    sun_angle: torch.Tensor  # []

    def kernel_row(self) -> rf.CameraRow:
        """The fused kernel's camera row of a whole frame."""
        return rf.camera_row(self)


def frame_inputs_from_camera(camera: Camera, sun_angle: float) -> FrameInputs:
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    return FrameInputs(
        inverse_view=f32(camera.inverse_view),
        inverse_projection=f32(camera.inverse_projection),
        camera_position=f32(camera.position),
        sun_angle=f32(sun_angle),
    )


class CameraFrame(NamedTuple):
    """Per-frame inputs left as the camera's host state (``Engine.render``'s
    frame): ``render_frame`` takes the fused kernel's camera row straight
    from it where its frame plan serves the frame, and its
    ``FrameInputs`` elsewhere."""

    camera: Camera
    sun_angle: float
    #: [16] f32: ``camera.inverse_projection``, kept by the caller for the
    #: camera's configuration and size
    inverse_projection: np.ndarray

    def inputs(self) -> FrameInputs:
        return frame_inputs_from_camera(self.camera, self.sun_angle)

    def kernel_row(self) -> rf.CameraRow:
        """``camera_row(self.inputs())``, bit for bit, from the kept
        projection inverse and the camera's own view inverse."""
        cam = self.camera
        row = np.concatenate([self.inverse_projection, cam.inverse_view.reshape(16),
                              np.asarray(cam.position, np.float32).reshape(3), _ROW0])
        return rf.CameraRow(cam=tuple(row.tolist()), sun=rf.sun_row(self.sun_angle))


#: cam[35] of a whole frame's camera row (``render_fused.camera_row``'s row0)
_ROW0 = np.zeros(1, np.float32)


def _trace_tiled(
    scene: Scene,
    frame: FrameInputs,
    width: int,
    height: int,
    bounces: int,
    tracer: Tracer = trace_best,
    reference_parity: bool = True,
    integer_colors: bool = True,
    enable_shadows: bool = False,
    enable_refraction: bool = False,
    refraction_ior: float = 1.45,
    enable_gi: bool = False,
    gi_seed: int = 0,
    post: bool = False,
) -> tuple[torch.Tensor, tuple]:
    """The JAX ``_trace_tiled`` (render.py:409): raw ``[3, rows, 128]``
    radiance in screen-tile order plus its ``("strip", trows, tiles_x,
    tiles_y)`` layout, from the fused kernel's in-kernel raygen where the
    tracer is K2.1's and the kernel covers the frame, else from the tiled
    camera rays through ``bounce_loop``. ``post``: the finished [H, W, 3]
    frame in place of the radiance (the post chain on the tile layout and
    the untiling; for a fused frame in its finish)."""
    tracer = resolve_tracer(tracer, scene)
    if tracer is trace and not enable_refraction and rf.fused_path_available(
        scene, reference_parity, integer_colors
    ):
        result, (trows, tiles_x, tiles_y) = rf.render_fused_camera(
            scene, frame, width, height, bounces, enable_shadows=enable_shadows,
            gi_seed=gi_seed if enable_gi else None, post=post,
        )
        return result, ("strip", trows, tiles_x, tiles_y)
    trows = rf.tile_rows(width * height)
    tiles_x = -(-width // 128)
    tiles_y = -(-height // trows)
    dev = scene.device
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32).to(dev)
    dirs = ray_directions_tiled(
        f32(frame.inverse_view), f32(frame.inverse_projection), width, height, trows
    )  # [3, tiles_y * tiles_x * trows, 128]
    origin = f32(frame.camera_position)[:, None, None].expand(dirs.shape)
    result = bounce_loop(
        scene, origin, dirs, f32(frame.sun_angle), bounces, tracer,
        reference_parity, integer_colors, enable_shadows, enable_refraction,
        refraction_ior, enable_gi, gi_seed,
    )
    layout = ("strip", trows, tiles_x, tiles_y)
    if post:
        result = rf.post_image(result, width, height, layout)
    return result, layout


def trace_image(
    scene: Scene,
    frame: FrameInputs,
    width: int,
    height: int,
    bounces: int = 2,
    tracer: Tracer = trace_best,
    reference_parity: bool = True,
    integer_colors: bool = True,
    enable_shadows: bool = False,
    enable_refraction: bool = False,
    refraction_ior: float = 1.45,
    enable_gi: bool = False,
    gi_seed: int = 0,
) -> torch.Tensor:
    """Linear [H, W, 3] radiance before post-processing (render.py:373 of
    the JAX package)."""
    result, layout = _trace_tiled(
        scene, frame, width, height, bounces, tracer, reference_parity, integer_colors,
        enable_shadows, enable_refraction, refraction_ior, enable_gi, gi_seed,
    )
    return rf.untile(result, layout, height, width).permute(1, 2, 0)


def _sample_offsets(n: int) -> list[tuple[float, float]]:
    """Sub-pixel sample offsets in [-0.5, 0.5) (render.py:472 of the JAX
    package): a rotated grid for 4 samples, centred Halton(2, 3) else."""
    if n == 4:
        return [(-0.125, -0.375), (0.375, -0.125), (-0.375, 0.125), (0.125, 0.375)]

    def halton(i: int, b: int) -> float:
        f, r = 1.0, 0.0
        while i > 0:
            f /= b
            r += f * (i % b)
            i //= b
        return r

    return [(halton(i + 1, 2) - 0.5, halton(i + 1, 3) - 0.5) for i in range(n)]


def jitter_projection(
    inverse_projection: torch.Tensor, dx: float, dy: float
) -> torch.Tensor:
    """The unprojection shifted by an NDC offset (dx, dy): raygen evaluates
    ``(cx, cy, 1, 1) @ invProj``, so adding ``dx*invProj[0] +
    dy*invProj[1]`` to row 3 shifts cx and cy, in the kernel's raygen too
    (render.py:491 of the JAX package)."""
    ip = torch.as_tensor(inverse_projection, dtype=torch.float32)
    out = ip.clone()
    out[3] = ip[3] + (dx * ip[0] + dy * ip[1])
    return out


def render_frame(
    scene: Scene,
    frame: FrameInputs,
    config: RenderConfig,
    device: str | torch.device | None = None,
    tracer: Tracer = trace_best,
) -> torch.Tensor:
    """Full frame: trace + post chain → [H, W, 3] on the scene's device
    (render.py:503 of the JAX package, its three branches). ``device``
    (None = the CUDA card) must be where the scene lies. ``frame``:
    ``FrameInputs``, or a ``CameraFrame``.

    A whole camera-mode K2.2 frame on the card (one sample, no FXAA, no
    refraction, K2.1's tracer, a scene the fused kernel covers) goes
    through the scene's kept frame plan (``render_fused.render_plan``):
    the same launches as ``render_fused_camera``'s, bit for bit, from
    parameters made once. Every other frame runs as below."""
    dev = resolve_device(device)
    w, h = config.width, config.height
    if (dev.type == "cuda" and config.samples == 1
            and not (config.enable_post and config.enable_fxaa)
            and not config.enable_refraction and config.reference_parity_shading
            and config.integer_colors and (tracer is trace_best or tracer is trace)):
        got = rf.render_plan(scene, frame, w, h, config.bounces, config.enable_shadows,
                             config.gi_seed if config.enable_gi else None, config.enable_post)
        if got is not None:
            img, (trows, tiles_x, tiles_y) = got
            if config.enable_post:
                return img
            return rf.untile(img, ("strip", trows, tiles_x, tiles_y), h, w).permute(1, 2, 0)
    if isinstance(frame, CameraFrame):
        frame = frame.inputs()
    if scene.device.type != dev.type:
        raise ValueError(f"scene is on {scene.device}, frame asked for {dev}")
    opts = dict(
        bounces=config.bounces,
        tracer=tracer,
        reference_parity=config.reference_parity_shading,
        integer_colors=config.integer_colors,
        enable_shadows=config.enable_shadows,
        enable_refraction=config.enable_refraction,
        refraction_ior=config.refraction_ior,
        enable_gi=config.enable_gi,
    )
    if config.samples > 1:
        # N sub-pixel-jittered frames averaged before post, each with its
        # own GI stream
        acc = None
        for si, (jx, jy) in enumerate(_sample_offsets(config.samples)):
            fj = frame._replace(inverse_projection=jitter_projection(
                frame.inverse_projection, jx * 2.0 / w, jy * 2.0 / h))
            img = trace_image(scene, fj, w, h, gi_seed=config.gi_seed + si, **opts)
            acc = img if acc is None else acc + img
        img = acc * (1.0 / config.samples)
        if config.enable_post:
            with ScopeTimer("render.post", log=False):
                img = post_process(img, enable_fxaa=config.enable_fxaa)
        return img
    if config.enable_post and not config.enable_fxaa:
        # the post chain on the tile layout: one relayout a frame (on the
        # card a fused frame's finish launch applies both)
        return _trace_tiled(scene, frame, w, h, gi_seed=config.gi_seed, post=True, **opts)[0]
    img = trace_image(scene, frame, w, h, gi_seed=config.gi_seed, **opts)
    if config.enable_post:
        with ScopeTimer("render.post", log=False):
            img = post_process(img, enable_fxaa=config.enable_fxaa)
    return img


def trace_planar(
    scene: Scene,
    origin: torch.Tensor,  # [3, *spatial]
    direction: torch.Tensor,  # [3, *spatial]
    sun_angle: torch.Tensor,  # [] f32
    bounces: int,
    tracer: Tracer,
    reference_parity: bool,
    integer_colors: bool,
    enable_shadows: bool = False,
    enable_refraction: bool = False,
    refraction_ior: float = 1.45,
    enable_gi: bool = False,
    gi_seed: int = 0,
) -> torch.Tensor:
    """N-bounce trace + shade over planar rays → [3, *spatial] radiance.
    The loop runs on ``[3, rows, 128]`` rays padded to a whole strip of
    ``render_fused.tile_rows`` rows, pad rays with origin 0 and direction
    1 (render.py:102 of the JAX package)."""
    spatial = tuple(direction.shape[1:])
    n = 1
    for s in spatial:
        n *= s
    tile = rf.tile_rows(n) * 128
    n_pad = -(-n // tile) * tile
    rows = n_pad // 128

    def to_linear(x: torch.Tensor, pad_value: float) -> torch.Tensor:
        flat = x.reshape(3, -1)
        if n_pad != n:
            pad = torch.full((3, n_pad - n), pad_value, dtype=flat.dtype,
                             device=flat.device)
            flat = torch.cat([flat, pad], dim=1)
        return flat.reshape(3, rows, 128)

    result = bounce_loop(
        scene, to_linear(origin, 0.0), to_linear(direction, 1.0), sun_angle,
        bounces, tracer, reference_parity, integer_colors, enable_shadows,
        enable_refraction, refraction_ior, enable_gi, gi_seed,
    )
    return result.reshape(3, -1)[:, :n].reshape((3,) + spatial)


def bounce_loop(
    scene: Scene,
    origin: torch.Tensor,  # [3, rows, 128]
    direction: torch.Tensor,  # [3, rows, 128]
    sun_angle: torch.Tensor,
    bounces: int,
    tracer: Tracer,
    reference_parity: bool,
    integer_colors: bool,
    enable_shadows: bool = False,
    enable_refraction: bool = False,
    refraction_ior: float = 1.45,
    enable_gi: bool = False,
    gi_seed: int = 0,
) -> torch.Tensor:
    """The N-bounce trace + shade core over ray-linear rays (render.py:155
    of the JAX package) → [3, rows, 128] radiance.

    With K2.1's tracer (``ops.trace.trace``) and a frame the fused kernel
    covers (``render_fused.fused_path_available``, no refraction) the whole
    loop is one launch of K2.2 in ray mode. The JAX package's
    ``fused_path_preferred`` picks the two-phase path for some streamed
    scenes, a choice between TPU table layouts; this port has no streamed
    tables, so the fused kernel is always preferred where it is available.

    Otherwise, two phases per bounce: trace (bounce 0 every ray, later
    bounces with the alive mask, so dead lanes cost no walk) and
    ``shade_hits``; the sun-shadow ray of bounce 0 goes through the same
    tracer. The float path of imported-texture scenes (reference parity,
    no refraction) gathers every bounce's texels in one combined gather
    after the loop (render.py:306-325)."""
    tracer = resolve_tracer(tracer, scene)
    if tracer is trace and not enable_refraction and rf.fused_path_available(
        scene, reference_parity, integer_colors
    ):
        return rf.render_fused(
            scene, origin, direction, sun_angle, bounces,
            enable_shadows=enable_shadows, gi_seed=gi_seed if enable_gi else None,
        )
    state = initial_bounce_state(origin, direction, sun_angle)
    defer_list: list | None = (
        [] if _DEFER_TEXELS and not integer_colors and reference_parity
        and not enable_refraction else None
    )
    ray_index = None
    if enable_gi:
        ray_index = torch.arange(origin[0].numel(), device=origin.device).reshape(
            origin.shape[1:])
        seeds = rng.gi_seed_rows(gi_seed, bounces)
    for b in range(bounces):
        if b == 0:
            hit = tracer(scene, state.origin, state.direction)
        else:
            hit = tracer(scene, state.origin, state.direction, live=state.alive)
        attrs = None
        if hit.attr_normal is not None:
            attrs = (hit.attr_normal, hit.attr_uu, hit.attr_vv, hit.attr_mat)
        # one decorrelated stream per ray per bounce: wang_hash(i * 9999 +
        # 1 + seed * 7919 + b * 1237) of the ray-linear index
        gi_state = None if ray_index is None else rng.ray_streams(ray_index, seeds[b])
        state = shade_hits(
            scene, state, t=hit.t, u=hit.u, v=hit.v, tri_idx=hit.tri,
            instance_idx=hit.instance, hit=hit.hit,
            reference_parity=reference_parity, integer_colors=integer_colors,
            attrs=attrs, shadow_tracer=tracer if enable_shadows and b == 0 else None,
            enable_refraction=enable_refraction, refraction_ior=refraction_ior,
            gi_state=gi_state, deferred=defer_list,
        )
    if not defer_list:
        return state.result
    idx_all = torch.stack([d[0] for d in defer_list])  # [B, rows, 128]
    tex_all = gather.take_rgb(scene.atlas.texels, idx_all)  # [3, B, rows, 128]
    res = state.result
    prod = None  # the GI colour product (1 on the mirror path)
    for b, (_idx, f1, f2, alb_p, live_b) in enumerate(defer_list):
        tx = tex_all[:, b]
        e = f1 if prod is None else f1 * prod
        res = res + tx * e + tx * f2
        if alb_p is not None:
            base = torch.ones_like(tx) if prod is None else prod
            prod = torch.where(live_b[None], base * (tx * alb_p), base)
    return res


def render(
    scene: Scene,
    camera: Camera,
    config: RenderConfig,
    device: str | torch.device | None = None,
    tracer: Tracer = trace_best,
) -> np.ndarray:
    """Convenience entry: an [H, W, 3] float numpy image."""
    frame = frame_inputs_from_camera(camera, config.sun_angle)
    return render_frame(scene, frame, config, device, tracer).cpu().numpy()


def to_srgb_u8(img: np.ndarray) -> np.ndarray:
    return (np.clip(np.asarray(img), 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def png_bytes(rgb8: np.ndarray) -> bytes:
    """An [H, W, 3] uint8 image as 8-bit RGB PNG bytes (zlib + struct
    only), row 0 at the top."""
    px = np.ascontiguousarray(rgb8, dtype=np.uint8)
    h, w, _ = px.shape
    raw = b"".join(b"\x00" + px[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        body = tag + data
        return (
            struct.pack(">I", len(data)) + body
            + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF)
        )

    return (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )


def frame_png(img: np.ndarray) -> bytes:
    """A frame [H, W, 3] as PNG bytes, row-flipped for display: the frame
    buffer is bottom-up like the reference's (kernel_main.cl:280-281), PNG
    row 0 is the top."""
    return png_bytes(to_srgb_u8(img)[::-1])


def save_png(path: str, img: np.ndarray) -> None:
    """Write the frame as an 8-bit RGB PNG (``frame_png``)."""
    with open(path, "wb") as f:
        f.write(frame_png(img))
