"""K2.2's ray mode on the CPU: ``render_fused.render_fused`` (the plain
version on given rays, then ``_finish_frame``) against the JAX package's
``render_pallas.render_fused`` (its fused kernel in Pallas interpret mode)
on the same seeded rays, in atlas modes 0, 1 and 2 with shadows and GI;
``render.trace_planar``'s routing to it; ray mode on a camera's tiled rays
against camera mode; and the rays a launch takes.

Tolerances as tests/test_torch_options.py, per ray: at least 99% within
1e-5, with GI at least 98% within 1e-3. Each JAX case compiles the Pallas
kernel in interpret mode (about 45 s on the CPU), so there are three.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from clraytracer_tpu.ops import render_pallas as jrp
from clraytracer_tpu_torch import render as trender
from clraytracer_tpu_torch.camera import Camera as TCamera
from clraytracer_tpu_torch.camera import ray_directions_tiled
from clraytracer_tpu_torch.config import CameraConfig as TCameraConfig
from clraytracer_tpu_torch.ops import render_fused, trace
from clraytracer_tpu_torch.scene.bridge import scene_from_numpy
from test_torch_options import _gi_scene, _ground_scene
from test_torch_scene import flatten

#: 16 rows of 128 rays: one strip
N_RAYS = 2048
SUN = -np.pi / 2  # overhead, as test_shadows.py:44
_built: dict = {}


def scenes(name):
    if name not in _built:
        js = {"ground": lambda: _ground_scene(False),
              "ground_atlas": lambda: _ground_scene(True)}[name]()
        _built[name] = (js, scene_from_numpy(*flatten(js), device="cpu"))
    return _built[name]


def seeded_rays(n=N_RAYS, seed=0):
    """Rays from around test_shadows.py's camera toward the ground and the
    sphere, each with its own origin: [3, n] origins and unit directions."""
    g = np.random.default_rng(seed)
    o = g.uniform(-1.0, 1.0, (3, n)).astype(np.float32) + np.float32([0.3, 4.0, 7.0])[:, None]
    d = np.float32([0.0, -0.5, -1.0])[:, None] + 0.4 * g.standard_normal((3, n)).astype(
        np.float32)
    return o, (d / np.linalg.norm(d, axis=0, keepdims=True)).astype(np.float32)


#: (scene, forced atlas mode 2, shadows, GI seed)
JAX_CASES = [
    ("ground", False, True, 3),
    ("ground_atlas", False, True, None),
    ("ground_atlas", True, False, 5),
]


@pytest.mark.parametrize("name,mode2,shadows,gi_seed", JAX_CASES,
                         ids=["atlas0-shadows-gi", "atlas1-shadows", "atlas2-gi"])
def test_ray_mode_matches_jax_render_fused(name, mode2, shadows, gi_seed, monkeypatch):
    js, ts = scenes(name)
    if mode2:  # more materials than the kernel reads rows for (test_trace.py:317)
        monkeypatch.setattr(jrp, "MAX_FUSED_MATERIALS", 0)
        monkeypatch.setattr(render_fused, "MAX_FUSED_MATERIALS", 0)
    mode = render_fused.atlas_mode_of(ts)
    assert mode == (2 if mode2 else 0 if name == "ground" else 1)
    o, d = seeded_rays()
    rows = N_RAYS // 128
    ref = np.asarray(jrp.render_fused(
        js, jnp.asarray(o.reshape(3, rows, 128)), jnp.asarray(d.reshape(3, rows, 128)),
        jnp.float32(SUN), 2, enable_shadows=shadows, gi_seed=gi_seed,
    ))
    calls = []
    plain = render_fused.render_fused_plain
    monkeypatch.setattr(render_fused, "render_fused_plain",
                        lambda *a, **k: calls.append(k) or plain(*a, **k))
    got = render_fused.render_fused(
        ts, torch.from_numpy(o).reshape(3, rows, 128), torch.from_numpy(d).reshape(3, rows, 128),
        torch.tensor(SUN, dtype=torch.float32), 2, enable_shadows=shadows, gi_seed=gi_seed,
    ).numpy()
    assert len(calls) == 1 and calls[0]["rays"].shape == (6, N_RAYS)
    assert got.shape == ref.shape == (3, rows, 128) and np.isfinite(got).all()
    tol, share = (1e-3, 0.98) if gi_seed is not None else (1e-5, 0.99)
    close = (np.abs(got - ref) <= tol).all(axis=0)
    print(f"{name} mode {mode}: {int((~close).sum())} of {close.size} rays off by > {tol}")
    assert close.mean() >= share, close.mean()
    assert (got > 0.0).any(axis=0).mean() > 0.5


def test_trace_planar_takes_ray_mode_for_integer_colours(monkeypatch):
    """``trace_planar`` with K2.1's tracer: integer-colour parity frames run
    the plain K2.2 once on the padded rays (pad rays start at 0 with
    direction 1) and equal ``render_fused`` on them; float colours and
    refraction take the two-phase path and no K2.2."""
    _js, ts = scenes("ground")
    o, d = seeded_rays(1000, seed=1)
    o3, d3 = torch.from_numpy(o).reshape(3, 40, 25), torch.from_numpy(d).reshape(3, 40, 25)
    sun = torch.tensor(SUN, dtype=torch.float32)
    calls = []
    plain = render_fused.render_fused_plain
    monkeypatch.setattr(render_fused, "render_fused_plain",
                        lambda *a, **k: calls.append(k["rays"]) or plain(*a, **k))
    got = trender.trace_planar(ts, o3, d3, sun, 2, trace.trace, True, True,
                               enable_shadows=True, enable_gi=True, gi_seed=2)
    assert got.shape == (3, 40, 25) and len(calls) == 1
    rays = calls[0]
    assert rays.shape == (6, 1024)  # one strip of 8 rows
    assert (rays[0:3, 1000:] == 0.0).all() and (rays[3:6, 1000:] == 1.0).all()
    pad_o = torch.cat([torch.from_numpy(o), torch.zeros(3, 24)], 1).reshape(3, 8, 128)
    pad_d = torch.cat([torch.from_numpy(d), torch.ones(3, 24)], 1).reshape(3, 8, 128)
    want = render_fused.render_fused(ts, pad_o, pad_d, sun, 2, enable_shadows=True, gi_seed=2)
    assert torch.equal(got, want.reshape(3, -1)[:, :1000].reshape(3, 40, 25))
    for kw in (dict(integer_colors=False), dict(enable_refraction=True)):
        args = {"reference_parity": True, "integer_colors": True, **kw}
        img = trender.trace_planar(ts, o3, d3, sun, 2, trace.trace, **args)
        assert img.shape == (3, 40, 25) and torch.isfinite(img).all()
    assert len(calls) == 2  # the comparison's own render_fused


@pytest.mark.parametrize("shadows,gi_seed", [(False, None), (True, 4)])
def test_ray_mode_on_tiled_rays_equals_camera_mode(shadows, gi_seed):
    """The plain K2.2 on a camera's tiled rays (camera.ray_directions_tiled,
    the raygen's expression order) gives camera mode's planes exactly,
    the GI streams included (ray i is seeded by i in both)."""
    _js, ts = scenes("ground_atlas")
    w, h = 200, 24
    cam = TCamera.create(TCameraConfig(position=(0.3, 4.0, 7.0), pitch_deg=-28.0), w, h)
    frame = trender.frame_inputs_from_camera(cam, SUN)
    trows = render_fused.tile_rows(w * h)
    rows_total = -(-h // trows) * -(-w // 128) * trows
    d = ray_directions_tiled(frame.inverse_view, frame.inverse_projection, w, h, trows)
    d = d.reshape(3, -1)
    rays = torch.cat([frame.camera_position[:, None].expand_as(d), d]).contiguous()
    args = (trace.kernel_tables(ts), trace.frame_tables(ts), render_fused.camera_row(frame),
            w, h, trows, rows_total, 2, torch.device("cpu"))
    opts = dict(atlas_mode=1, shadows=shadows, gi_seed=gi_seed)
    cam_out = render_fused.render_fused_plain(*args, **opts)
    ray_out = render_fused.render_fused_plain(*args, rays=rays, **opts)
    # bit for bit (mode 1's pool-index planes are i32 bits, some of them NaN)
    assert torch.equal(cam_out.view(torch.int32), ray_out.view(torch.int32))


def test_ray_mode_takes_a_ragged_last_row_and_refuses_bad_rays():
    """n need not be a multiple of 128: the last row is ragged, and the
    output has n columns equal to the first n of a padded launch; rays of
    another shape, type or row count are refused."""
    _js, ts = scenes("ground")
    o, d = seeded_rays(300, seed=2)
    rays = torch.from_numpy(np.concatenate([o, d]))
    kt, ft = trace.kernel_tables(ts), trace.frame_tables(ts)
    cr = render_fused.ray_row(torch.tensor(SUN))
    geo = (128, 3, 3, 3, 2, torch.device("cpu"))
    got = render_fused.render_fused_plain(kt, ft, cr, *geo, rays=rays, shadows=True)
    padded = torch.cat([rays, torch.zeros(6, 84)], 1).contiguous()
    full = render_fused.render_fused_plain(kt, ft, cr, *geo, rays=padded, shadows=True)
    assert got.shape == (9, 300) and torch.equal(got, full[:, :300])
    for bad, rows in ((rays[:5].contiguous(), 3), (rays.double(), 3), (rays.t(), 3),
                      (rays, 2), (rays, 4)):
        with pytest.raises(ValueError):
            render_fused.check_rays(bad, rows)
    before = render_fused.render_cuda.launches
    with pytest.raises(ValueError):  # the kernel takes CUDA tensors only
        render_fused.render_cuda(kt, ft, cr, *geo[:5], rays=rays)
    assert render_fused.render_cuda.launches == before
