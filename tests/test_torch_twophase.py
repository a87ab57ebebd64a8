"""The port's two-phase frame (K2.1's plain version per bounce and
``ops.shade.shade_hits``, on the CPU) against the JAX package's two-phase
path on the same scenes and cameras: refraction, sun shadows and GI, each
with integer and float colours and with reference-parity and material
shading; a 65-material all-procedural scene; ``shade_hits`` itself on the
same hit records; and the refraction direction against Snell's law.

The JAX frames take ``tracer=trace_brute`` (its golden tracer: every
triangle against every ray, on the two-phase XLA path) but for one frame
through the JAX package's default tracer (the K2.1 Pallas kernel in
interpret mode) with its fused kernel turned off, as test_trace.py:291-294
does. (``trace_wavefront`` keeps the reference's inside-box miss quirk,
test_trace.py:35, which parts it from K2.1 on rays that start inside the
glass sphere's box.) A frame the
port's fused kernel would take is forced onto the port's two-phase path
the same way. Tolerances as tests/test_torch_options.py: at least 99% of
pixels within 1e-5, with GI at least 98% within 1e-3; refraction frames
at least 99% within 1e-5 too.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from clraytracer_tpu import math3d as jmath3d
from clraytracer_tpu.camera import Camera as JCamera
from clraytracer_tpu.config import CameraConfig as JCameraConfig
from clraytracer_tpu.config import RenderConfig as JRenderConfig
from clraytracer_tpu.ops.trace_ref import trace_brute
from clraytracer_tpu.render import frame_inputs_from_camera as j_frame_inputs
from clraytracer_tpu.render import render_frame as j_render_frame
from clraytracer_tpu.scene import SceneBuilder as JSceneBuilder
from clraytracer_tpu.scene import procedural_tex as jptex
from clraytracer_tpu.scene.procedural import cube as jcube
from clraytracer_tpu.scene.procedural import uv_sphere as juv_sphere
from clraytracer_tpu.scene.textures import gradient_sky as jgradient_sky
from clraytracer_tpu_torch import render as trender
from clraytracer_tpu_torch.camera import Camera as TCamera
from clraytracer_tpu_torch.config import CameraConfig as TCameraConfig
from clraytracer_tpu_torch.config import RenderConfig as TRenderConfig
from clraytracer_tpu_torch.ops import render_fused, trace
from clraytracer_tpu_torch.ops import shade as tshade
from clraytracer_tpu_torch.scene.bridge import scene_from_numpy
from test_torch_options import _gi_scene, _ground_scene, assert_frames_agree
from test_torch_scene import flatten

W, H = 32, 24
IOR = 1.45


def _glass_scene():
    """test_refraction.py:96-108: a transmissive sphere before a backdrop
    sphere, imported sky."""
    b = JSceneBuilder()
    b.import_texture(jgradient_sky(64, 32))
    m_glass = b.create_material(albedo=(0.95, 0.98, 1.0), transmission=0.85)
    m_back = b.create_material(albedo=(0.9, 0.5, 0.3))
    b.add_instance(b.add_mesh(juv_sphere(1.5, 10, 16), materials_start=m_glass),
                   jmath3d.translation(0.0, 0.5, 2.5))
    b.add_instance(b.add_mesh(juv_sphere(2.5, 10, 16), materials_start=m_back),
                   jmath3d.translation(0.0, 0.5, -3.0))
    return b.build()


def _glass_cube_scene(transmission=0.9):
    """test_refraction.py:26-31: a glass cube of half-size 2 at the
    origin."""
    b = JSceneBuilder()
    b.import_texture(jgradient_sky(64, 32))
    m = b.create_material(albedo=(1.0, 1.0, 1.0), transmission=transmission)
    b.add_instance(b.add_mesh(jcube(2.0), materials_start=m))
    return b.build()


def _many_materials_scene():
    """An all-procedural scene of 65 materials (past the fused kernel's
    64): a checkered sphere and a cube whose materials are the last."""
    b = JSceneBuilder()
    b.import_procedural(jptex.sky_gradient(64, 32))
    checker = b.import_procedural(jptex.checker(16, 4))
    m1 = b.create_material(albedo=(0.9, 0.6, 0.3), albedo_tex=checker,
                           specular=(0.6, 0.6, 0.6), shininess=8.0, roughness=0.3)
    while len(b._materials) < 64:
        b.create_material(albedo=(0.5, 0.5, 0.5))
    m2 = b.create_material(albedo=(0.2, 0.8, 0.3), specular_tex=checker)
    b.add_instance(b.add_mesh(juv_sphere(1.5, 8, 12), materials_start=m1),
                   jmath3d.translation(-1.5, 0.5, 0.0))
    b.add_instance(b.add_mesh(jcube(1.0), materials_start=m2),
                   jmath3d.rotation_y(0.7) @ jmath3d.translation(2.0, 0.5, -1.0))
    return b.build()


SCENES = {
    "glass": _glass_scene,
    "glass_cube": _glass_cube_scene,
    "ground": lambda: _ground_scene(False),
    "ground_atlas": lambda: _ground_scene(True),
    "gi": lambda: _gi_scene(False),
    "gi_atlas": lambda: _gi_scene(True),
    "many": _many_materials_scene,
}
#: (camera position, pitch, sun angle) per scene
VIEWS = {
    "glass": ((0.0, 0.5, 9.0), 0.0, -1.96),  # test_refraction.py:109
    "glass_cube": ((0.0, 0.0, 6.0), 0.0, -1.96),  # test_refraction.py:124
    "ground": ((0.3, 4.0, 7.0), -28.0, -np.pi / 2),  # test_shadows.py:38-44
    "ground_atlas": ((0.3, 4.0, 7.0), -28.0, -np.pi / 2),
    "gi": ((0.1, 0.2, 8.0), 0.0, -1.96),  # test_gi.py:34
    "gi_atlas": ((0.1, 0.2, 8.0), 0.0, -1.96),
    "many": ((0.13, 0.21, 10.0), 0.0, -1.96),
}
_built: dict = {}


def scenes(name):
    """(JAX scene, the port's copy through the bridge), built once."""
    if name not in _built:
        js = SCENES[name]()
        _built[name] = (js, scene_from_numpy(*flatten(js), device="cpu"))
    return _built[name]


def jax_frame(name, tracer=trace_brute, **cfg):
    pos, pitch, sun = VIEWS[name]
    cam = JCamera.create(JCameraConfig(position=pos, pitch_deg=pitch), W, H)
    args = (scenes(name)[0], j_frame_inputs(cam, sun), JRenderConfig(width=W, height=H, **cfg))
    return np.asarray(j_render_frame(*args) if tracer is None
                      else j_render_frame(*args, tracer=tracer))


def port_frame(name, **cfg):
    pos, pitch, sun = VIEWS[name]
    cam = TCamera.create(TCameraConfig(position=pos, pitch_deg=pitch), W, H)
    return trender.render_frame(
        scenes(name)[1], trender.frame_inputs_from_camera(cam, sun),
        TRenderConfig(width=W, height=H, **cfg), device="cpu",
    ).numpy()


COLOURS = [dict(integer_colors=ic, reference_parity_shading=rp)
           for ic in (True, False) for rp in (True, False)]
#: (scene, option) of each family: test_refraction.py's, test_shadows.py's
#: and test_gi.py's scenes with their option
FAMILIES = [
    ("glass", dict(enable_refraction=True, refraction_ior=IOR)),
    ("ground", dict(enable_shadows=True)),
    ("gi", dict(enable_gi=True, enable_post=False)),
    ("ground_atlas", dict(enable_shadows=True, enable_post=False)),
    ("gi_atlas", dict(enable_gi=True, bounces=3)),
]
CASES = [(name, {**opt, **col}) for name, opt in FAMILIES for col in COLOURS]


def _id(name, cfg):
    return f"{name}-" + "-".join(f"{k}={v}" for k, v in cfg.items())


@pytest.mark.parametrize("name,cfg", CASES, ids=[_id(n, c) for n, c in CASES])
def test_two_phase_frame_matches_jax(name, cfg, monkeypatch):
    """Every frame on the port's two-phase path (the fused kernel's own
    frames forced there) against the JAX two-phase frame."""
    monkeypatch.setattr(render_fused, "fused_path_available", lambda *a: False)
    ref = jax_frame(name, **cfg)
    got = port_frame(name, **cfg)
    assert_frames_agree(got, ref, cfg.get("enable_gi", False), _id(name, cfg))


def test_two_phase_frame_matches_jax_pallas_tracer(monkeypatch):
    """The JAX two-phase frame through its default tracer (the Pallas K2.1
    kernel in interpret mode, its fused kernel turned off) with integer
    colours and shadows: the port's two-phase path, forced the same way."""
    from clraytracer_tpu.ops import render_pallas as rp

    cfg = dict(enable_shadows=True, enable_post=False)
    monkeypatch.setattr(rp, "fused_path_available", lambda *a: False)
    ref = jax_frame("ground", tracer=None, **cfg)
    monkeypatch.setattr(render_fused, "fused_path_available", lambda *a: False)
    got = port_frame("ground", **cfg)
    assert_frames_agree(got, ref, False, "ground, pallas tracer")


@pytest.mark.parametrize("cfg", [{}, dict(reference_parity_shading=False, enable_gi=True)],
                         ids=["default", "material-gi"])
def test_many_materials_frame_matches_jax(cfg):
    """65 materials, every texture procedural: the fused kernel does not
    cover the scene, so both packages take the two-phase path; the port
    launches no K2.2 on the CPU either."""
    js, ts = scenes("many")
    assert ts.materials.count == 65
    assert not render_fused.fused_path_available(ts, True, True)
    ref = jax_frame("many", **cfg)
    got = port_frame("many", **cfg)
    assert_frames_agree(got, ref, cfg.get("enable_gi", False), "many")


def test_refraction_frame_differs_from_reflection():
    """The refracted glass frame is not the mirror frame
    (test_refraction.py:115-118)."""
    on = port_frame("glass", enable_refraction=True, enable_post=False)
    off = port_frame("glass", enable_post=False)
    assert np.abs(on - off).max() > 0.05


# ---------------------------------------------------------------------------
# shade_hits on the same hit records
# ---------------------------------------------------------------------------


def _rays(name, n=384, seed=0):
    """Seeded rays from around the scene's camera toward it."""
    pos, _pitch, _sun = VIEWS[name]
    g = np.random.default_rng(seed)
    o = g.uniform(-0.5, 0.5, (3, n)).astype(np.float32) + np.float32(pos)[:, None]
    aim = -np.float32(pos)[:, None] + g.uniform(-2.5, 2.5, (3, n)).astype(np.float32)
    return o, (aim / np.linalg.norm(aim, axis=0, keepdims=True)).astype(np.float32)


SHADE_CASES = [
    ("glass", dict(enable_refraction=True, refraction_ior=IOR, integer_colors=False,
                   reference_parity=False)),
    ("glass", dict(enable_refraction=True, refraction_ior=IOR)),
    ("ground_atlas", dict(reference_parity=False)),
    ("ground_atlas", dict(integer_colors=False, reference_parity=False)),
    ("many", dict(reference_parity=False)),
    ("gi", dict(gi=True, integer_colors=False)),
]


@pytest.mark.parametrize("name,kw", SHADE_CASES, ids=[_id(n, c) for n, c in SHADE_CASES])
@pytest.mark.parametrize("port_attrs", [False, True], ids=["gathered", "tracer"])
def test_shade_hits_matches_jax(name, kw, port_attrs):
    """One bounce of ``shade_hits`` in both packages on the same hit
    records (JAX ``trace_brute``'s, attributes gathered and
    interpolated in shade), and in the port with K2.1's interpolated
    attributes too: every state field within 1e-5 on 99% of rays."""
    from clraytracer_tpu.ops import rng as jrng
    from clraytracer_tpu.ops.shade import initial_bounce_state as j_init
    from clraytracer_tpu.ops.shade import shade_hits as j_shade
    from clraytracer_tpu_torch.ops import rng as trng

    js, ts = scenes(name)
    o, d = _rays(name)
    sun = VIEWS[name][2]
    hit = trace_brute(js, jnp.asarray(o), jnp.asarray(d))
    kw = dict(kw)
    gi = kw.pop("gi", False)
    idx = np.arange(o.shape[1], dtype=np.uint32)
    j_gi = jrng.wang_hash(jnp.asarray(idx) * jnp.uint32(9999) + jnp.uint32(17)) if gi else None
    t_gi = trng.wang_hash(torch.from_numpy(idx.astype(np.int64)) * 9999 + 17) if gi else None
    ref = j_shade(js, j_init(jnp.asarray(o), jnp.asarray(d), jnp.float32(sun)),
                  t=hit.t, u=hit.u, v=hit.v, tri_idx=hit.tri, instance_idx=hit.instance,
                  hit=hit.hit, gi_state=j_gi, **kw)
    tt = lambda x: torch.from_numpy(np.array(x))
    attrs = None
    if port_attrs:
        th = trace.trace(ts, tt(o), tt(d))
        assert (th.hit == tt(hit.hit)).double().mean() >= 0.99
        attrs = (th.attr_normal, th.attr_uu, th.attr_vv, th.attr_mat)
    state = tshade.initial_bounce_state(tt(o), tt(d), torch.tensor(sun, dtype=torch.float32))
    got = tshade.shade_hits(ts, state, t=tt(hit.t), u=tt(hit.u), v=tt(hit.v),
                            tri_idx=tt(hit.tri), instance_idx=tt(hit.instance),
                            hit=tt(hit.hit), attrs=attrs, gi_state=t_gi, **kw)
    assert int(np.asarray(hit.hit).sum()) > 50
    for field in ref._fields:
        r, g = np.asarray(getattr(ref, field)), getattr(got, field).numpy()
        assert g.shape == r.shape, field
        if field == "alive":
            assert (g == r).all()
            continue
        close = (np.abs(g - r) <= 1e-5 + 1e-5 * np.abs(r)).reshape(-1, r.shape[-1]).all(axis=0)
        assert close.mean() >= 0.99, (field, close.mean())


# ---------------------------------------------------------------------------
# refraction against Snell's law
# ---------------------------------------------------------------------------


def _shade_one(o3, d3):
    """One ray traced (K2.1's plain version) and shaded on the glass cube."""
    _js, ts = scenes("glass_cube")
    o = torch.tensor(o3, dtype=torch.float32).reshape(3, 1)
    d = torch.tensor(d3, dtype=torch.float32)
    d = (d / torch.linalg.vector_norm(d)).reshape(3, 1)
    h = trace.trace(ts, o, d)
    assert bool(h.hit[0]), "test ray must hit the cube"
    state = tshade.initial_bounce_state(o, d, torch.tensor(-1.96))
    st = tshade.shade_hits(
        ts, state, t=h.t, u=h.u, v=h.v, tri_idx=h.tri, instance_idx=h.instance, hit=h.hit,
        attrs=(h.attr_normal, h.attr_uu, h.attr_vv, h.attr_mat),
        enable_refraction=True, refraction_ior=IOR,
    )
    return st, d.reshape(3).double().numpy()


def _snell(d, n, eta):
    ci = -float(d @ n)
    k = 1.0 - eta * eta * (1.0 - ci * ci)
    if k < 0.0:
        return None
    out = eta * d + n * (eta * ci - np.sqrt(k))
    return out / np.linalg.norm(out)


def test_refraction_direction_matches_snell():
    """Entering the cube's +z face (test_refraction.py:48-68): the
    continuation is Snell's refraction, starts just behind the face (z <
    2, the face of the cube) and carries the transmission."""
    st, d = _shade_one((0.3, 0.2, 5.0), (0.25, -0.1, -1.0))
    want = _snell(d, np.array([0.0, 0.0, 1.0]), 1.0 / IOR)
    np.testing.assert_allclose(st.direction.reshape(3).numpy(), want, atol=1e-6)
    assert float(st.origin[2, 0]) < 2.0
    np.testing.assert_allclose(st.energy.reshape(3).numpy(), 0.9, atol=1e-6)


def test_refraction_exits_glass_by_snell_or_mirror():
    """Rays that start inside the cube meet the +z face from behind: the
    normal flips (n_eff = -n) and the index inverts (eta = ior). A shallow
    ray leaves by Snell's law and starts just outside (z > 2); a steep one
    is totally reflected along the mirror ray, whose origin is offset
    along the outward normal as every mirror continuation's is
    (shade.py:590)."""
    st, d = _shade_one((0.1, 0.0, 0.0), (0.2, 0.1, 1.0))
    n_eff = np.array([0.0, 0.0, -1.0])
    want = _snell(d, n_eff, IOR)
    assert want is not None and want[2] > 0.0
    np.testing.assert_allclose(st.direction.reshape(3).numpy(), want, atol=1e-6)
    assert float(st.origin[2, 0]) > 2.0
    st, d = _shade_one((0.0, 0.0, 0.0), (0.7, 0.6, 0.55))
    n = np.array([1.0, 0.0, 0.0])  # meets the +x face first
    assert _snell(d, -n, IOR) is None
    mirror = d - 2.0 * float(d @ n) * n
    np.testing.assert_allclose(st.direction.reshape(3).numpy(), mirror, atol=1e-6)
    np.testing.assert_allclose(float(st.origin[0, 0]), 2.01, atol=1e-5)


def test_opaque_material_unaffected_by_refraction(monkeypatch):
    """transmission 0: the flag changes nothing on the two-phase path
    (test_refraction.py:84)."""
    monkeypatch.setattr(render_fused, "fused_path_available", lambda *a: False)
    ts = scene_from_numpy(*flatten(_glass_cube_scene(0.0)), device="cpu")
    cam = TCamera.create(TCameraConfig(position=(0.0, 0.0, 6.0)), W, H)
    frame = trender.frame_inputs_from_camera(cam, -1.96)
    on = trender.render_frame(ts, frame, TRenderConfig(width=W, height=H,
                                                       enable_refraction=True), device="cpu")
    off = trender.render_frame(ts, frame, TRenderConfig(width=W, height=H), device="cpu")
    assert torch.equal(on, off)


def test_cli_render_glass_with_refraction(tmp_path):
    from clraytracer_tpu_torch.cli import main

    out = tmp_path / "glass.png"
    assert main(["render", "--scene", "glass", "--width", "24", "--height", "16",
                 "--device", "cpu", "--refraction", "--ior", "1.5", "-o", str(out)]) == 0
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
