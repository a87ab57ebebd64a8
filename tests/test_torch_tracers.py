"""The port's reference tracers (plain torch, on the CPU) against the JAX
package's: the intersection primitives on tests/test_trace.py's cases,
``trace_brute``/``trace_bvh``/``trace_wavefront`` hit for hit, the
wavefront chunked against unchunked, ``render_frame`` through every
``TRACERS`` name against the JAX frame through the same tracer, and the
differentiable step on wavefront hits against the JAX step."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clraytracer_tpu.camera import Camera as JCamera
from clraytracer_tpu.camera import ray_directions_planar as j_rays
from clraytracer_tpu.config import CameraConfig as JCameraConfig
from clraytracer_tpu.config import RenderConfig as JRenderConfig
from clraytracer_tpu.ops import intersect as j_isect
from clraytracer_tpu.ops import trace_ref as j_ref
from clraytracer_tpu.ops import trace_wavefront as j_wave
from clraytracer_tpu.render import TRACERS as J_TRACERS
from clraytracer_tpu.render import frame_inputs_from_camera as j_frame_inputs
from clraytracer_tpu.render import render_frame as j_render_frame
from clraytracer_tpu.scene.types import MISS_DISTANCE
from clraytracer_tpu_torch import diff as tdiff
from clraytracer_tpu_torch import render as trender
from clraytracer_tpu_torch.camera import Camera as TCamera
from clraytracer_tpu_torch.config import CameraConfig as TCameraConfig
from clraytracer_tpu_torch.config import RenderConfig as TRenderConfig
from clraytracer_tpu_torch.ops import intersect as t_isect
from clraytracer_tpu_torch.ops import render_fused, trace
from clraytracer_tpu_torch.ops import trace_ref as t_ref
from clraytracer_tpu_torch.ops import trace_wavefront as t_wave
from clraytracer_tpu_torch.scene.bridge import scene_from_numpy
from test_torch_scene import flatten

W, H = 32, 24
TRACER_PAIRS = {
    "brute": (j_ref.trace_brute, t_ref.trace_brute),
    "bvh": (j_ref.trace_bvh, t_ref.trace_bvh),
    "wavefront": (j_wave.trace_wavefront, t_wave.trace_wavefront),
}


def _t(x):
    return torch.as_tensor(np.asarray(x, np.float32))


# ---------------------------------------------------------------------------
# intersection primitives (tests/test_trace.py:17-65)
# ---------------------------------------------------------------------------


TRI = ([0.0, 0.0, -5.0], [1.0, 0.0, -5.0], [0.0, 1.0, -5.0])


@pytest.mark.parametrize(
    "direction, best_t, accepted",
    [([0.0, 0.0, -1.0], MISS_DISTANCE, True),  # the basic hit
     ([0.0, 0.0, 1.0], MISS_DISTANCE, False),  # behind the ray
     ([0.0, 0.0, -1.0], 4.0, False)],  # best_t closer than the hit
    ids=["hit", "behind", "farther-than-best"],
)
def test_moller_trumbore_matches_jax(direction, best_t, accepted):
    o = [0.2, 0.2, 0.0]
    ref = j_isect.moller_trumbore(
        jnp.asarray(o), jnp.asarray(direction), *(jnp.asarray(v) for v in TRI),
        jnp.asarray(best_t, jnp.float32),
    )
    got = t_isect.moller_trumbore(
        _t(o), _t(direction), *(_t(v) for v in TRI), torch.tensor(best_t)
    )
    assert bool(got[3]) == bool(ref[3]) == accepted
    for a, b in zip(ref[:3], got[:3]):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=1e-6)


@pytest.mark.parametrize(
    "bmin, bmax, expect_hit",
    [([-1.0, -1.0, -10.0], [1.0, 1.0, -5.0], True),
     # a ray starting inside the box misses it (kernel_main.cl:115)
     ([-1.0, -1.0, -1.0], [1.0, 1.0, 1.0], False)],
    ids=["ahead", "inside-box-quirk"],
)
def test_aabb_matches_jax(bmin, bmax, expect_hit):
    o, d = [0.0, 0.0, 0.0], np.float32([0.0, 0.0, -1.0])
    with np.errstate(divide="ignore"):
        inv = np.float32(1.0) / d
    ref = float(j_isect.intersect_aabb(
        jnp.asarray(o), jnp.asarray(inv), jnp.asarray(bmin), jnp.asarray(bmax),
        jnp.asarray(MISS_DISTANCE, jnp.float32)))
    got = float(t_isect.intersect_aabb(
        _t(o), _t(inv), _t(bmin), _t(bmax), torch.tensor(MISS_DISTANCE)))
    assert got == ref
    assert (got < 1e29) == expect_hit
    if expect_hit:
        assert got == pytest.approx(5.0, rel=1e-6)


def test_intersect_tris_matches_jax():
    rng = np.random.default_rng(3)
    v = rng.normal(size=(3, 64, 3)).astype(np.float32)
    o = rng.normal(size=(200, 3)).astype(np.float32) * 0.3 + np.float32([0, 0, 4])
    d = (rng.normal(size=(200, 3)) * 0.3 + [0, 0, -1]).astype(np.float32)
    best = np.full(200, MISS_DISTANCE, np.float32)
    best[:50] = 3.5
    ref = j_isect.intersect_tris(*(jnp.asarray(x) for x in (o, d, *v, best)), tri_offset=7)
    got = t_isect.intersect_tris(*(torch.from_numpy(x) for x in (o, d, *v, best)),
                                 tri_offset=7)
    assert int(got.hit.sum()) > 10
    np.testing.assert_array_equal(got.hit.numpy(), np.asarray(ref.hit))
    np.testing.assert_array_equal(got.tri.numpy(), np.asarray(ref.tri))
    for f in ("t", "u", "v"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(ref, f)),
                                   rtol=0, atol=1e-5, err_msg=f)


# ---------------------------------------------------------------------------
# the three tracers hit for hit
# ---------------------------------------------------------------------------


def _camera_rays(w, h, position):
    cam = JCamera.create(JCameraConfig(position=position), w, h)
    d = np.array(j_rays(jnp.asarray(cam.inverse_view),
                        jnp.asarray(cam.inverse_projection), w, h))
    o = np.broadcast_to(np.asarray(cam.position, np.float32)[:, None, None], d.shape)
    return np.ascontiguousarray(o), d


def assert_hits_equal(ref, got, label):
    """Indices exactly, t/u/v and the object-space rays within 1e-5."""
    for f in ("hit", "tri", "instance"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(ref, f)),
                                      err_msg=f"{label}: {f}")
    hit = np.asarray(ref.hit)
    for f in ("t", "u", "v"):
        a, b = np.asarray(getattr(ref, f)), getattr(got, f).numpy()
        np.testing.assert_allclose(b[hit], a[hit], rtol=0, atol=1e-5, err_msg=f"{label}: {f}")
    for f in ("mesh_origin", "mesh_direction"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(ref, f)),
                                   rtol=0, atol=1e-5, err_msg=f"{label}: {f}")


@pytest.mark.parametrize("name", list(TRACER_PAIRS))
@pytest.mark.parametrize(
    "fixture, position",
    [("sphere_scene", (0.13, 0.21, 10.0)), ("two_instance_scene", (0.0, 1.0, 8.0))],
)
def test_tracer_matches_jax(name, fixture, position, request):
    jscene = request.getfixturevalue(fixture)
    scene = scene_from_numpy(*flatten(jscene), device="cpu")
    o, d = _camera_rays(W, H, position)
    j_fn, t_fn = TRACER_PAIRS[name]
    ref = j_fn(jscene, jnp.asarray(o), jnp.asarray(d))
    got = t_fn(scene, torch.from_numpy(o), torch.from_numpy(d))
    assert got.t.shape == (H, W) and got.mesh_origin.shape == (H, W, 3)
    assert int(got.hit.sum()) > 20
    assert_hits_equal(ref, got, f"{fixture} {name}")


def test_tracers_live_mask_reports_dead_lanes_as_misses(two_instance_scene):
    """A live mask traces the live rays only: they keep their hits, and the
    dead lanes report a miss with their own ray as the object-space ray."""
    scene = scene_from_numpy(*flatten(two_instance_scene), device="cpu")
    o, d = (torch.from_numpy(x) for x in _camera_rays(W, H, (0.0, 1.0, 8.0)))
    live = torch.from_numpy(np.random.default_rng(1).uniform(size=(H, W)) < 0.5)
    for fn in (t_ref.trace_brute, t_ref.trace_bvh, t_wave.trace_wavefront):
        full, part = fn(scene, o, d), fn(scene, o, d, live=live)
        for f in ("t", "u", "v", "tri", "instance", "hit"):
            assert torch.equal(getattr(part, f)[live], getattr(full, f)[live]), f
        assert not part.hit[~live].any()
        assert (part.t[~live] == MISS_DISTANCE).all()
        assert torch.equal(part.mesh_direction[~live], d.permute(1, 2, 0)[~live])


def test_wavefront_chunked_matches_unchunked(two_instance_scene, monkeypatch):
    """WAVEFRONT_CHUNK-ray chunks (the last one padded) give the unchunked
    hits, as tests/test_trace.py:488 holds the JAX tracer."""
    scene = scene_from_numpy(*flatten(two_instance_scene), device="cpu")
    o, d = (torch.from_numpy(x) for x in _camera_rays(W, H, (0.0, 1.0, 8.0)))
    whole = t_wave.trace_wavefront(scene, o, d)
    monkeypatch.setattr(t_wave, "WAVEFRONT_CHUNK", 100)  # 768 rays: 8 chunks, padded
    chunked = t_wave.trace_wavefront(scene, o, d)
    for a, b in zip(whole, chunked):
        if a is not None:
            assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# frames through every TRACERS name
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_frames(two_instance_scene):
    """The JAX ``render_frame`` of ``two_instance_scene`` at 32x24 through
    each of its ``TRACERS``."""
    jcam = JCamera.create(JCameraConfig(position=(0.13, 0.21, 10.0)), W, H)
    frame = j_frame_inputs(jcam, -1.96)
    cfg = JRenderConfig(width=W, height=H)
    return {name: np.asarray(j_render_frame(two_instance_scene, frame, cfg, tracer=fn))
            for name, fn in J_TRACERS.items()}


@pytest.mark.parametrize("name", ["best", "brute", "bvh", "wavefront", "pallas"])
def test_render_frame_tracer_matches_jax(name, jax_frames, two_instance_scene):
    """At least 99% of pixels within 1e-5 (the frame tests' bound); "best"
    and "pallas" take the kernels' plain versions (the fused frame on this
    imported-texture scene), the others the two-phase path."""
    assert set(trender.TRACERS) == set(J_TRACERS)
    scene = scene_from_numpy(*flatten(two_instance_scene), device="cpu")
    cam = TCamera.create(TCameraConfig(position=(0.13, 0.21, 10.0)), W, H)
    frame = trender.frame_inputs_from_camera(cam, -1.96)
    before = render_fused.render_cuda.launches, trace.trace_cuda.launches
    got = trender.render_frame(scene, frame, TRenderConfig(width=W, height=H),
                               device="cpu", tracer=trender.TRACERS[name]).numpy()
    assert (render_fused.render_cuda.launches, trace.trace_cuda.launches) == before
    ref = jax_frames[name]
    assert got.shape == ref.shape == (H, W, 3) and np.isfinite(got).all()
    bad = (np.abs(got - ref) > 1e-5).any(axis=-1)
    print(f"{name}: {int(bad.sum())} of {bad.size} pixels differ by > 1e-5")
    assert bad.mean() <= 0.01


# ---------------------------------------------------------------------------
# the differentiable step on wavefront hits
# ---------------------------------------------------------------------------


def test_diff_on_wavefront_matches_jax(sphere_scene):
    """``render_image_diff(base_tracer=trace_wavefront)``: image within 1e-5
    on 99% of pixels, and the gradients of sum(img * weights) within rtol
    1e-3 on the material colours and instance transforms and on 99% of the
    triangle and texel rows (the bound of tests/test_torch_diff.py)."""
    from clraytracer_tpu.diff import render_image_diff as j_render_diff

    w, h = 16, 12
    weights = np.random.default_rng(0).uniform(0.0, 1.0, (h, w, 3)).astype(np.float32)
    frame = j_frame_inputs(JCamera.create(JCameraConfig(position=(0.13, 0.21, 10.0)), w, h),
                           -1.96)

    @jax.jit
    def step(s, wt):
        img, vjp = jax.vjp(lambda q: j_render_diff(
            q, frame, w, h, base_tracer=j_wave.trace_wavefront), s)
        return img, vjp(wt)[0]

    ref_img, g = step(sphere_scene, jnp.asarray(weights))
    scene = scene_from_numpy(*flatten(sphere_scene), device="cpu")
    tframe = trender.frame_inputs_from_camera(
        TCamera.create(TCameraConfig(position=(0.13, 0.21, 10.0)), w, h), -1.96)
    before = trace.trace_cuda.launches
    img = tdiff.render_image_diff(scene, tframe, w, h, device="cpu",
                                  base_tracer=t_wave.trace_wavefront)
    bad = (np.abs(img.detach().numpy() - np.asarray(ref_img)) > 1e-5).any(axis=-1)
    assert bad.mean() <= 0.01
    wt = torch.from_numpy(weights)
    _, grads = tdiff.image_loss_and_grads(
        scene, tframe, w, h, loss_fn=lambda im: torch.sum(im * wt), device="cpu",
        base_tracer=t_wave.trace_wavefront)
    assert trace.trace_cuda.launches == before
    for key in ("materials.albedo", "instances.inverse_transform", "tris.v0",
                "tris.n0", "atlas.texels"):
        group, leaf = key.split(".")
        a = np.asarray(getattr(getattr(g, group), leaf), np.float64)
        b = grads[key].numpy().astype(np.float64)
        assert np.abs(a).max() > 0 and np.abs(b).max() > 0, key
        scale = np.abs(a).max()
        if group in ("materials", "instances"):
            np.testing.assert_allclose(b, a, rtol=1e-3, atol=1e-6 * scale, err_msg=key)
        else:
            ok = np.abs(b - a) <= 1e-3 * np.abs(a) + 1e-4 * scale
            assert ok.reshape(ok.shape[0], -1).all(axis=1).mean() >= 0.99, key


def test_diff_base_tracer_default_follows_cluster_tables(sphere_scene, monkeypatch):
    """``render_image_diff`` without a base tracer takes K2.1 (slot ids,
    the slot-ordered table) on a scene with cluster tables and
    ``trace_wavefront`` (arena ids) on one without, with equal images."""
    scene = scene_from_numpy(*flatten(sphere_scene), device="cpu")
    frame = trender.frame_inputs_from_camera(
        TCamera.create(TCameraConfig(position=(0.13, 0.21, 10.0)), 16, 12), -1.96)
    calls = []
    real = t_wave.trace_wavefront

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(tdiff, "trace_wavefront", counting)
    with_tables = tdiff.render_image_diff(scene, frame, 16, 12, device="cpu")
    assert not calls
    without = tdiff.render_image_diff(dataclasses.replace(scene, clusters=None), frame,
                                      16, 12, device="cpu")
    assert calls
    bad = (np.abs(with_tables.numpy() - without.numpy()) > 1e-5).any(axis=-1)
    assert bad.mean() <= 0.01
