"""The port's frame options (plain versions, on the CPU) against the JAX
``render_frame`` on the same scenes and cameras: imported textures (the
fused kernel's atlas modes 1 and 2, row and flat-u32 texel pools), sun
shadows, Monte-Carlo GI, supersampling and FXAA; and the untiled post
chain against the JAX chain.

Tolerances: at least 99% of pixels within 1e-5 without GI (the seams and
texel flips of tests/test_torch_render.py); with GI at least 98% within
1e-3 (tests/test_gi.py:76: trig rounding moves a continuation ray, and at
silhouettes its next hit). One frame goes through the JAX fused kernel in
Pallas interpret mode (``test_fused_kernel_frame_matches_jax``); the others through the JAX package's
two-phase XLA path (``tracer=trace_wavefront``), which its own tests hold
to the fused kernel (test_trace.py:300, test_shadows.py:80, test_gi.py:60).
FXAA and supersampling run on the one-instance sphere: on the two-instance
scene the two-phase path parts from the JAX fused kernel on 6 seam pixels
of 768 (9 with jittered cameras, where the port's frame equals the fused
kernel's), and FXAA spreads each of them to its neighbours.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from clraytracer_tpu import math3d as jmath3d
from clraytracer_tpu.camera import Camera as JCamera
from clraytracer_tpu.config import CameraConfig as JCameraConfig
from clraytracer_tpu.config import RenderConfig as JRenderConfig
from clraytracer_tpu.ops.trace_wavefront import trace_wavefront
from clraytracer_tpu.render import frame_inputs_from_camera as j_frame_inputs
from clraytracer_tpu.render import render_frame as j_render_frame
from clraytracer_tpu.scene import SceneBuilder as JSceneBuilder
from clraytracer_tpu.scene import procedural_tex as jptex
from clraytracer_tpu.scene.procedural import quad as jquad
from clraytracer_tpu.scene.procedural import uv_sphere as juv_sphere
from clraytracer_tpu.scene.textures import checkerboard as jcheckerboard
from clraytracer_tpu.scene.textures import gradient_sky as jgradient_sky
from clraytracer_tpu_torch import render as trender
from clraytracer_tpu_torch.camera import Camera as TCamera
from clraytracer_tpu_torch.config import CameraConfig as TCameraConfig
from clraytracer_tpu_torch.config import RenderConfig as TRenderConfig
from clraytracer_tpu_torch.ops import render_fused
from clraytracer_tpu_torch.scene.bridge import scene_from_numpy
from test_torch_scene import flatten

W, H = 32, 24
#: (camera position, pitch, sun angle) of each scene family
VIEWS = {
    "bench": ((0.13, 0.21, 10.0), 0.0, -1.96),
    "ground": ((0.3, 4.0, 7.0), -28.0, -np.pi / 2),  # test_shadows.py:38-44
    "gi": ((0.1, 0.2, 8.0), 0.0, -1.96),  # test_gi.py:34
}


def _ground_scene(atlas: bool):
    """test_shadows.py:88-98: a checkered ground quad under a red sphere;
    with ``atlas`` the textures are imported images (their bakes)."""
    b = JSceneBuilder()
    if atlas:
        b.import_texture(jgradient_sky(32, 16))
        checker = b.import_texture(jcheckerboard(16, 4))
    else:
        b.import_procedural(jptex.sky_gradient(32, 16))
        checker = b.import_procedural(jptex.checker(16, 4))
    ground = b.create_material(albedo=(0.85, 0.85, 0.85), albedo_tex=checker)
    red = b.create_material(albedo=(0.9, 0.2, 0.2))
    b.add_instance(b.add_mesh(jquad(8.0, y=0.0), materials_start=ground))
    b.add_instance(
        b.add_mesh(juv_sphere(1.0, n_lat=8, n_lon=14), materials_start=red),
        jmath3d.translation(0.0, 1.6, 0.0),
    )
    return b.build()


def _gi_scene(atlas: bool):
    """test_gi.py:22-30 (``gi_scene``) and :80-92 (``gi_atlas_scene``)."""
    b = JSceneBuilder()
    if atlas:
        b.import_texture(jgradient_sky(32, 16))
        checker = b.import_texture(jcheckerboard(16, 4))
    else:
        b.import_procedural(jptex.sky_gradient(32, 16))
        checker = b.import_procedural(jptex.checker(16, 4))
    mat = b.create_material(albedo=(0.9, 0.6, 0.3), albedo_tex=checker)
    b.add_instance(b.add_mesh(juv_sphere(2.0, n_lat=8, n_lon=16), materials_start=mat))
    return b.build()


SCENES = {
    "ground": lambda rq: _ground_scene(False),
    "ground_atlas": lambda rq: _ground_scene(True),
    "gi": lambda rq: _gi_scene(False),
    "gi_atlas": lambda rq: _gi_scene(True),
    "sphere_atlas": lambda rq: rq.getfixturevalue("sphere_scene"),
    "two_atlas": lambda rq: rq.getfixturevalue("two_instance_scene"),
}
_built: dict = {}


def _scenes(name, request):
    """(JAX scene, the port's copy of it through the bridge), built once."""
    if name not in _built:
        js = SCENES[name](request)
        _built[name] = (js, scene_from_numpy(*flatten(js), device="cpu"))
    return _built[name]


def _view(name):
    return VIEWS["ground" if name.startswith("ground") else
                 "gi" if name.startswith("gi") else "bench"]


_jax_frames: dict = {}


def jax_frame(name, request, tracer=trace_wavefront, **cfg):
    """The JAX frame of scene ``name`` (computed once per configuration)."""
    key = (name, tracer, tuple(sorted(cfg.items())))
    if key not in _jax_frames:
        pos, pitch, sun = _view(name)
        cam = JCamera.create(JCameraConfig(position=pos, pitch_deg=pitch), W, H)
        args = (_scenes(name, request)[0], j_frame_inputs(cam, sun),
                JRenderConfig(width=W, height=H, **cfg))
        _jax_frames[key] = np.asarray(j_render_frame(*args) if tracer is None
                                      else j_render_frame(*args, tracer=tracer))
    return _jax_frames[key]


def port_frame(scene, view, **cfg):
    pos, pitch, sun = view
    cam = TCamera.create(TCameraConfig(position=pos, pitch_deg=pitch), W, H)
    return trender.render_frame(
        scene, trender.frame_inputs_from_camera(cam, sun),
        TRenderConfig(width=W, height=H, **cfg), device="cpu",
    ).numpy()


def assert_frames_agree(got, ref, gi: bool, label=""):
    assert got.shape == ref.shape == (H, W, 3)
    assert np.isfinite(got).all()
    tol, share = (1e-3, 0.98) if gi else (1e-5, 0.99)
    close = (np.abs(got - ref) <= tol).all(axis=-1)
    print(f"{label}: {int((~close).sum())} of {close.size} pixels off by > {tol}")
    assert close.mean() >= share, close.mean()


#: (scene, port atlas mode, config) held against the JAX two-phase path
CASES = [
    ("sphere_atlas", 1, {}),
    ("two_atlas", 1, {}),
    ("two_atlas", 1, dict(enable_shadows=True, enable_post=False)),
    ("ground", 0, dict(enable_shadows=True)),
    ("ground_atlas", 1, dict(enable_shadows=True)),
    ("gi", 0, dict(enable_gi=True, enable_post=False)),
    ("gi", 0, dict(enable_gi=True, bounces=3)),
    ("gi_atlas", 1, dict(enable_gi=True, enable_post=False)),
    ("gi_atlas", 1, dict(enable_gi=True, bounces=3, gi_seed=5)),
    ("gi_atlas", 1, dict(enable_gi=True, samples=4, enable_shadows=True)),
    ("sphere_atlas", 1, dict(samples=2, enable_fxaa=True)),
    ("sphere_atlas", 1, dict(samples=3, enable_fxaa=True, enable_shadows=True)),
]


@pytest.mark.parametrize(
    "name,mode,cfg", CASES,
    ids=[f"{n}-" + ("-".join(f"{k}={v}" for k, v in c.items()) or "default")
         for n, _m, c in CASES],
)
def test_frame_matches_jax(name, mode, cfg, request):
    ts = _scenes(name, request)[1]
    assert render_fused.atlas_mode_of(ts) == mode
    ref = jax_frame(name, request, **cfg)
    got = port_frame(ts, _view(name), **cfg)
    assert_frames_agree(got, ref, cfg.get("enable_gi", False), name)


@pytest.mark.parametrize("name", ["sphere_atlas", "two_atlas", "ground_atlas"])
def test_atlas_mode_2_matches_jax(name, request, monkeypatch):
    """More materials than the kernel reads rows for (the bound
    monkeypatched to 0, as test_trace.py:317-321 does): the material id and
    (uu, vv) are emitted and the rows read in ``_finish_frame``."""
    ts = _scenes(name, request)[1]
    cfg = dict(enable_shadows=True) if name == "ground_atlas" else {}
    ref = jax_frame(name, request, **cfg)
    monkeypatch.setattr(render_fused, "MAX_FUSED_MATERIALS", 0)
    assert render_fused.atlas_mode_of(ts) == 2
    got = port_frame(ts, _view(name), **cfg)
    assert_frames_agree(got, ref, False, name)


def test_atlas_gi_mode_2_matches_jax(request, monkeypatch):
    ts = _scenes("gi_atlas", request)[1]
    cfg = dict(enable_gi=True, enable_post=False)
    ref = jax_frame("gi_atlas", request, **cfg)
    monkeypatch.setattr(render_fused, "MAX_FUSED_MATERIALS", 0)
    got = port_frame(ts, _view("gi_atlas"), **cfg)
    assert_frames_agree(got, ref, True, "gi_atlas mode 2")


def test_fused_kernel_frame_matches_jax(request):
    """The one frame held against the JAX fused kernel itself (its default
    tracer, Pallas interpret mode): atlas mode 1 with shadows and GI on
    the ground scene."""
    ts = _scenes("ground_atlas", request)[1]
    cfg = dict(enable_shadows=True, enable_gi=True, enable_post=False)
    ref = jax_frame("ground_atlas", request, tracer=None, **cfg)
    got = port_frame(ts, _view("ground"), **cfg)
    assert_frames_agree(got, ref, True, "fused ground_atlas")


def test_flat_texel_pool_equals_row_gather(monkeypatch):
    """Pools past ``FLAT_TEXEL_MIN`` texels gather packed-RGB8 words: the
    frame equals the row gather's bit for bit, in both atlas modes (as
    test_trace.py:331-364)."""
    from clraytracer_tpu_torch.scene import SceneBuilder, builder
    from clraytracer_tpu_torch.scene.procedural import uv_sphere
    from clraytracer_tpu_torch.scene.textures import checkerboard, gradient_sky

    def build():
        b = SceneBuilder()
        b.import_texture(gradient_sky(128, 64))
        checker = b.import_texture(checkerboard(32, 4))
        mat = b.create_material(albedo=(0.9, 0.6, 0.3), albedo_tex=checker)
        b.add_instance(b.add_mesh(uv_sphere(2.0, n_lat=8, n_lon=12), materials_start=mat))
        return b.build(device="cpu")

    row = build()
    assert row.packed.texels_u32 is None
    monkeypatch.setattr(builder, "FLAT_TEXEL_MIN", 0)
    flat = build()
    assert flat.packed.texels_u32 is not None
    view = VIEWS["bench"]
    for mode_cap in (64, 0):
        monkeypatch.setattr(render_fused, "MAX_FUSED_MATERIALS", mode_cap)
        cfg = dict(enable_gi=True, enable_post=False)
        np.testing.assert_array_equal(port_frame(row, view, **cfg), port_frame(flat, view, **cfg))


def test_shadows_darken_occluded_ground(request):
    """As test_shadows.py:47-65, on the port: shadows only remove light, a
    patch of ground under the sphere darkens, most of the frame holds."""
    _js, ts = _scenes("ground", request)
    lit = port_frame(ts, VIEWS["ground"], enable_post=False)
    shadowed = port_frame(ts, VIEWS["ground"], enable_post=False, enable_shadows=True)
    diff = lit - shadowed
    assert diff.min() >= -1e-5
    darkened = (diff.max(axis=-1) > 0.05).mean()
    assert 0.005 < darkened < 0.5, darkened
    assert (np.abs(diff).max(axis=-1) < 1e-6).mean() > 0.5


@pytest.mark.parametrize("name", ["gi", "gi_atlas"])
def test_gi_seed_deterministic_and_decorrelated(name, request):
    _js, ts = _scenes(name, request)
    a = port_frame(ts, VIEWS["gi"], enable_gi=True, gi_seed=0, enable_post=False)
    a2 = port_frame(ts, VIEWS["gi"], enable_gi=True, gi_seed=0, enable_post=False)
    b = port_frame(ts, VIEWS["gi"], enable_gi=True, gi_seed=1, enable_post=False)
    mirror = port_frame(ts, VIEWS["gi"], enable_post=False)
    np.testing.assert_array_equal(a, a2)
    assert np.abs(a - b).max() > 1e-4
    assert np.abs(a - mirror).max() > 1e-3 and (a >= 0.0).all()


def _image(seed=0, h=H, w=W):
    img = np.random.default_rng(seed).uniform(0.0, 2.0, (h, w, 3)).astype(np.float32)
    img[3:9, 5:20] = 0.05  # flat patches and hard edges for FXAA
    img[0, :4] = 0.0  # the l_old == 0 branch
    return img


def test_fxaa_matches_jax():
    from clraytracer_tpu.ops.post import fxaa as j_fxaa
    from clraytracer_tpu_torch.ops.post import fxaa as t_fxaa

    img = _image(1)
    ref = np.asarray(j_fxaa(jnp.asarray(img)))
    got = t_fxaa(torch.from_numpy(img)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    assert np.abs(got - img).max() > 1e-3


@pytest.mark.parametrize("enable_fxaa", [False, True])
def test_post_process_matches_jax(enable_fxaa):
    from clraytracer_tpu.ops.post import post_process as j_post
    from clraytracer_tpu_torch.ops.post import post_process as t_post

    img = _image(2, 24, 40)
    ref = np.asarray(j_post(jnp.asarray(img), enable_fxaa=enable_fxaa))
    got = t_post(torch.from_numpy(img), enable_fxaa=enable_fxaa).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def test_vignette_mask_matches_jax():
    """``post_process``'s separable vignette (one row of factors times one
    column) is the JAX package's per-pixel ``vignette_mask``."""
    from clraytracer_tpu.ops.post import vignette_mask as j_vig
    from clraytracer_tpu_torch.ops.post import _vignette_factors

    got = _vignette_factors(24, 24)[:, None] * _vignette_factors(40, 40)[None, :]
    np.testing.assert_allclose(got.numpy(), np.asarray(j_vig(24, 40)), rtol=0, atol=1e-6)


def test_sample_offsets_and_jitter_match_jax():
    from clraytracer_tpu.render import _sample_offsets as j_offsets
    from clraytracer_tpu.render import jitter_projection as j_jitter

    for n in (2, 3, 4, 5):
        assert trender._sample_offsets(n) == j_offsets(n)
    ip = np.random.default_rng(3).standard_normal((4, 4)).astype(np.float32)
    ref = np.asarray(j_jitter(jnp.asarray(ip), 0.0123, -0.0456))
    got = trender.jitter_projection(torch.from_numpy(ip), 0.0123, -0.0456).numpy()
    np.testing.assert_array_equal(got, ref)


def test_cli_render_with_every_option(tmp_path):
    from clraytracer_tpu_torch.cli import main

    out = tmp_path / "o.png"
    assert main(["render", "--scene", "two", "--width", "24", "--height", "16",
                 "--device", "cpu", "--shadows", "--gi", "--gi-seed", "3",
                 "--spp", "2", "--fxaa", "-o", str(out)]) == 0
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


@pytest.mark.parametrize("mode,gi", [(1, False), (1, True), (2, False), (2, True)])
def test_deferred_planes_layout(mode, gi, request, monkeypatch):
    """The plain K2.2's deferred planes (csrc/render.cu's layout): 9 + K*B
    planes; shaded lanes carry a pool index / material id >= 0, lanes that
    miss at a bounce -1, dead lanes 0 (mode 1) or -2 (mode 2), and every
    unshaded lane zero coefficients."""
    from clraytracer_tpu_torch.ops.trace import frame_tables, kernel_tables

    ts = _scenes("two_atlas", request)[1]
    if mode == 2:
        monkeypatch.setattr(render_fused, "MAX_FUSED_MATERIALS", 0)
    assert render_fused.atlas_mode_of(ts) == mode
    pos, pitch, sun = VIEWS["bench"]
    cam = TCamera.create(TCameraConfig(position=pos, pitch_deg=pitch), W, H)
    cr = render_fused.camera_row(trender.frame_inputs_from_camera(cam, sun))
    trows = render_fused.tile_rows(W * H)
    rows_total = -(-H // trows) * trows
    out = render_fused.render_fused_plain(
        kernel_tables(ts), frame_tables(ts), cr, W, H, trows, rows_total, 3,
        torch.device("cpu"), atlas_mode=mode, gi_seed=0 if gi else None,
    )
    k = render_fused.deferred_planes(mode, gi)
    assert k == (7 if mode == 1 else 6) + (3 if gi else 0)
    assert out.shape == (9 + 3 * k, rows_total * 128)
    seen = set()
    for b in range(3):
        blk = out[9 + k * b: 9 + k * (b + 1)]
        head = blk[0].view(torch.int32) if mode == 1 else blk[0]
        dead_value = 0 if mode == 1 else -2
        shaded = head >= 0 if mode == 2 else blk[1:4].abs().sum(0) + blk[-3:].abs().sum(0) > 0
        miss = head == -1
        coefs = blk[4 if mode == 1 else 3:]
        assert (coefs[:, miss] == 0).all()
        if mode == 2:
            assert (coefs[:, head == dead_value] == 0).all() and (blk[1:3, ~shaded] == 0).all()
        seen |= {"miss"} if miss.any() else set()
        seen |= {"shaded"} if shaded.any() else set()
    assert seen == {"miss", "shaded"}
