"""The port's frame (plain versions, on the CPU) against the JAX
``render_frame`` on the same scene and camera; the post chain against the
JAX post chain; the options this package once refused (the two-phase
path) against the JAX frame; and that the port loads neither JAX nor the
JAX package. The other options are held against JAX in
tests/test_torch_options.py and tests/test_torch_twophase.py."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from clraytracer_tpu.camera import Camera as JCamera
from clraytracer_tpu.config import CameraConfig as JCameraConfig
from clraytracer_tpu.config import RenderConfig as JRenderConfig
from clraytracer_tpu.render import frame_inputs_from_camera as j_frame_inputs
from clraytracer_tpu.render import render_frame as j_render_frame
from clraytracer_tpu_torch import render as trender
from clraytracer_tpu_torch.camera import Camera as TCamera
from clraytracer_tpu_torch.config import CameraConfig as TCameraConfig
from clraytracer_tpu_torch.config import RenderConfig as TRenderConfig
from clraytracer_tpu_torch.ops import render_fused, trace
from clraytracer_tpu_torch.scene.bridge import scene_from_numpy
from test_torch_scene import flatten

CAMERA = dict(position=(0.13, 0.21, 10.0))
W, H = 64, 48


@pytest.fixture(scope="module")
def flagship_scene():
    from __graft_entry__ import _flagship_scene

    return _flagship_scene()


@pytest.fixture(scope="module")
def port_procedural(procedural_scene):
    return scene_from_numpy(*flatten(procedural_scene), device="cpu")


def _port_frame(scene, w=W, h=H, **cfg):
    cam = TCamera.create(TCameraConfig(**CAMERA), w, h)
    frame = trender.frame_inputs_from_camera(cam, -1.96)
    return trender.render_frame(
        scene, frame, TRenderConfig(width=w, height=h, **cfg), device="cpu"
    )


@pytest.mark.parametrize("fixture", ["procedural_scene", "flagship_scene"])
def test_frame_matches_jax_render_frame(fixture, request):
    """At least 99% of pixels within 1e-5 (test_trace.py:296's bound; the
    rest are seam ties and texel flips, test_trace.py:380)."""
    jscene = request.getfixturevalue(fixture)
    jcam = JCamera.create(JCameraConfig(**CAMERA), W, H)
    ref = np.asarray(
        j_render_frame(
            jscene, j_frame_inputs(jcam, -1.96), JRenderConfig(width=W, height=H)
        )
    )
    port = scene_from_numpy(*flatten(jscene), device="cpu")
    got = _port_frame(port).numpy()
    assert got.shape == ref.shape == (H, W, 3)
    assert np.isfinite(got).all()
    bad = (np.abs(got - ref) > 1e-5).any(axis=-1)
    print(f"{fixture}: {int(bad.sum())} of {bad.size} pixels differ by > 1e-5")
    assert bad.mean() <= 0.01


def test_post_process_tiled_matches_jax():
    from clraytracer_tpu.ops.post import post_process_tiled as j_post
    from clraytracer_tpu_torch.ops.post import post_process_tiled as t_post

    layout = ("strip", 24, 1, 2)
    p = np.random.default_rng(0).uniform(0.0, 2.0, (3, 48, 128)).astype(np.float32)
    p[:, 0, :4] = 0.0  # the l_old == 0 branch
    ref = np.asarray(j_post(jnp.asarray(p), W, H, layout))
    got = t_post(torch.from_numpy(p), W, H, layout).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def _jax_brute_frame(jscene, w, h, **cfg):
    """The JAX ``render_frame`` through its golden tracer (every triangle
    against every ray, on its two-phase path)."""
    from clraytracer_tpu.ops.trace_ref import trace_brute

    jcam = JCamera.create(JCameraConfig(**CAMERA), w, h)
    return np.asarray(j_render_frame(
        jscene, j_frame_inputs(jcam, -1.96), JRenderConfig(width=w, height=h, **cfg),
        tracer=trace_brute,
    ))


def _assert_close_frames(got, ref, label):
    assert got.shape == ref.shape and np.isfinite(got).all()
    bad = (np.abs(got - ref) > 1e-5).any(axis=-1)
    print(f"{label}: {int(bad.sum())} of {bad.size} pixels differ by > 1e-5")
    assert bad.mean() <= 0.01


@pytest.mark.parametrize(
    "option",
    [
        dict(enable_refraction=True),
        dict(reference_parity_shading=False),
        dict(integer_colors=False),
    ],
    ids=lambda o: next(iter(o)),
)
def test_unported_options_raise(option, procedural_scene, port_procedural):
    """The options this package refused before it took the two-phase path
    (K2.1 per bounce, shading in torch) now render, as the JAX
    ``render_frame`` does with the same option: at least 99% of pixels
    within 1e-5, at 32x24."""
    ref = _jax_brute_frame(procedural_scene, 32, 24, **option)
    got = _port_frame(port_procedural, 32, 24, **option).numpy()
    _assert_close_frames(got, ref, next(iter(option)))


def test_too_many_materials_raise():
    """An all-procedural scene of more materials than the fused kernel
    reads rows for, refused before the two-phase path: it renders as the
    JAX ``render_frame`` does (at least 99% of pixels within 1e-5)."""
    from clraytracer_tpu.scene import SceneBuilder as JSceneBuilder
    from clraytracer_tpu.scene.procedural import cube as jcube

    b = JSceneBuilder()
    for _ in range(render_fused.MAX_FUSED_MATERIALS):
        b.create_material()
    b.add_instance(b.add_mesh(jcube(1.0)))
    jscene = b.build()
    scene = scene_from_numpy(*flatten(jscene), device="cpu")
    assert scene.materials.count > render_fused.MAX_FUSED_MATERIALS
    assert not render_fused.fused_path_available(scene, True, True)
    got = _port_frame(scene, 32, 24).numpy()
    _assert_close_frames(got, _jax_brute_frame(jscene, 32, 24), "65 materials")


def test_scene_without_tables_raises(procedural_scene, port_procedural):
    """A scene without cluster tables, once refused, renders through
    ``trace_wavefront`` (``render.trace_best``), as the JAX ``render_frame``
    does (its ``resolve_tracer``): at least 99% of pixels within 1e-5 of
    the JAX frame, and no kernel launched."""
    import dataclasses

    from clraytracer_tpu.ops.trace_ref import trace_brute

    jscene = dataclasses.replace(procedural_scene, clusters=None)
    scene = dataclasses.replace(port_procedural, clusters=None)
    assert trender.resolve_tracer(trender.trace_best, scene) is trender.trace_wavefront
    before = (render_fused.render_cuda.launches, trace.trace_cuda.launches)
    got = _port_frame(scene, 32, 24).numpy()
    assert (render_fused.render_cuda.launches, trace.trace_cuda.launches) == before
    jcam = JCamera.create(JCameraConfig(**CAMERA), 32, 24)
    ref = np.asarray(j_render_frame(
        jscene, j_frame_inputs(jcam, -1.96), JRenderConfig(width=32, height=24)))
    _assert_close_frames(got, ref, "without cluster tables")
    _assert_close_frames(got, _jax_brute_frame(procedural_scene, 32, 24), "against brute")


def test_cpu_frame_launches_no_kernel(port_procedural, two_instance_scene):
    """Neither the default frame nor a shadows + GI frame of an imported-
    texture scene launches a kernel on the CPU."""
    atlas = scene_from_numpy(*flatten(two_instance_scene), device="cpu")
    assert render_fused.atlas_mode_of(atlas) == 1
    before = (render_fused.render_cuda.launches, trace.trace_cuda.launches,
              dict(render_fused.render_cuda.variant_launches))
    img = _port_frame(port_procedural, 16, 8)
    assert img.shape == (8, 16, 3)
    img = _port_frame(atlas, 16, 8, enable_shadows=True, enable_gi=True, samples=2)
    assert img.shape == (8, 16, 3) and torch.isfinite(img).all()
    assert (render_fused.render_cuda.launches, trace.trace_cuda.launches,
            render_fused.render_cuda.variant_launches) == before


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "from clraytracer_tpu_torch.cli import build_scene\n"
        "from clraytracer_tpu_torch.camera import Camera\n"
        "from clraytracer_tpu_torch.config import CameraConfig, RenderConfig\n"
        "from clraytracer_tpu_torch.render import render\n"
        "s = build_scene('two', device='cpu')\n"
        "cam = Camera.create(CameraConfig(position=(0.13, 0.21, 10.0)), 32, 24)\n"
        "img = render(s, cam, RenderConfig(width=32, height=24), device='cpu')\n"
        "assert img.shape == (24, 32, 3), img.shape\n"
        "img = render(s, cam, RenderConfig(width=32, height=24, enable_shadows=True,\n"
        "             enable_gi=True, samples=2, enable_fxaa=True), device='cpu')\n"
        "assert img.shape == (24, 32, 3), img.shape\n"
        "img = render(s, cam, RenderConfig(width=32, height=24, enable_refraction=True,\n"
        "             integer_colors=False, reference_parity_shading=False,\n"
        "             enable_shadows=True), device='cpu')\n"
        "assert img.shape == (24, 32, 3), img.shape\n"
        "import torch\n"
        "from clraytracer_tpu_torch.ops.trace import trace\n"
        "from clraytracer_tpu_torch.render import trace_planar\n"
        "o = torch.tensor([0.1, 0.2, 9.0]).reshape(3, 1).expand(3, 300).contiguous()\n"
        "d = torch.nn.functional.normalize(torch.randn(3, 300) * 0.2\n"
        "    + torch.tensor([0.0, 0.0, -1.0])[:, None], dim=0)\n"
        "assert trace_planar(s, o, d, torch.tensor(-1.96), 2, trace, True, True).shape == (3, 300)\n"
        "from clraytracer_tpu_torch.diff import image_loss_and_grads\n"
        "from clraytracer_tpu_torch.render import frame_inputs_from_camera\n"
        "from clraytracer_tpu_torch import cli\n"
        "loss, g = image_loss_and_grads(s, frame_inputs_from_camera(cam, -1.96),\n"
        "                               32, 24, device='cpu')\n"
        "assert g['materials.albedo'].abs().max() > 0, g\n"
        "import os, tempfile\n"
        "from clraytracer_tpu_torch.scene import SceneBuilder\n"
        "from clraytracer_tpu_torch.scene.procedural import cube\n"
        "from clraytracer_tpu_torch.scene.clm import save_clm\n"
        "from clraytracer_tpu_torch.scene.obj import load_obj\n"
        "from clraytracer_tpu_torch.scene.imagefile import decode_image\n"
        "from clraytracer_tpu_torch.ops.trace_wavefront import trace_wavefront\n"
        "from clraytracer_tpu_torch.ops.trace_ref import trace_brute, trace_bvh\n"
        "from clraytracer_tpu_torch.render import TRACERS\n"
        "tmp = tempfile.mkdtemp()\n"
        "open(os.path.join(tmp, 'q.obj'), 'w').write('mtllib q.mtl\\nv 0 0 0\\nv 1 0 0\\n'\n"
        "    'v 1 1 0\\nv 0 1 0\\nvt 0 0\\nvt 1 1\\nusemtl m\\nf 1/1 2/2 3/2 4/1\\n')\n"
        "open(os.path.join(tmp, 'q.mtl'), 'w').write('newmtl m\\nKd 1 0.5 0\\nmap_Kd t.ppm\\n')\n"
        "open(os.path.join(tmp, 't.ppm'), 'wb').write(b'P6 2 1 255\\n' + bytes(range(6)))\n"
        "assert decode_image(os.path.join(tmp, 't.ppm')).shape == (1, 2, 3)\n"
        "save_clm(os.path.join(tmp, 'c.clm'), load_obj(os.path.join(tmp, 'q.obj')))\n"
        "for f in ('q.obj', 'c.clm'):\n"
        "    b = SceneBuilder()\n"
        "    b.add_instance(b.import_mesh(os.path.join(tmp, f)))\n"
        "    b.add_instance(b.add_mesh(cube(0.5)))\n"
        "    s2 = b.build(device='cpu')\n"
        "    assert render(s2, cam, RenderConfig(width=32, height=24), device='cpu',\n"
        "                  tracer=TRACERS['wavefront']).shape == (24, 32, 3)\n"
        "snap = os.path.join(tmp, 's.clsnap.npz')\n"
        "assert cli.main(['snapshot', '--scene', os.path.join(tmp, 'q.obj'), '--device', 'cpu',\n"
        "                 '-o', snap]) == 0\n"
        "s3 = cli.build_scene(snap, device='cpu')\n"
        "for fn in (trace_wavefront, trace_bvh, trace_brute):\n"
        "    assert fn(s3, o, d).hit.shape == (300,)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'clraytracer_tpu' or m.startswith('clraytracer_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
        timeout=300,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("ok")


def test_chip_smoke_bound_is_this_runs_with_the_per_ray_walks_beside():
    """chip_smoke.py bounds K2.1/K2.2 by this run's counts, prints beside it
    the bound the per-ray walk's counts give at the same shapes, and reads
    nvcc's register and spill report per kernel (runs without a card)."""
    import chip_smoke as cs

    key = ("K2.2", "a", 4224)
    for counts in ([10**10, 0, 0, 0, 5, 6], [1, 0, 0, 0, 5, 6]):
        b = cs.walk_bound(key, 1e6, counts, 1000, shade=True)
        assert (b["bound_ms"], b["bound_by"]) == cs.bound(1e6, counts, 1000, True)
        assert b["bound_ms_per_ray_walk_counts"] == cs.bound(
            1e6, cs.PER_RAY_WALK_COUNTS[key], 1000, True)[0]
    assert "bound_ms_per_ray_walk_counts" not in cs.walk_bound(("K2.2", "x", 1), 1e6, counts)
    log = (
        "ptxas info    : Compiling entry function '_Z12trace_kernelv' for 'sm_90a'\n"
        "    16 bytes stack frame, 12 bytes spill stores, 8 bytes spill loads\n"
        "ptxas info    : Used 85 registers, used 1 barriers, 18480 bytes smem\n"
    )
    assert cs.ptxas_summary(log) == [{
        "kernel": "_Z12trace_kernelv", "spill_stores": 12, "spill_loads": 8,
        "registers": 85, "smem_bytes": 18480,
    }]


def test_chip_smoke_walk_bytes_count_what_the_rays_need():
    """The bytes of a K2.1/K2.2 bound: box tables whole, plane rows only of
    the clusters that hold a winning triangle, attribute rows only of the
    winning triangles; all clusters and all slots give back the whole
    tables."""
    import chip_smoke as cs
    from clraytracer_tpu_torch.cli import build_scene

    scene = build_scene("two", device="cpu")
    kt, ft = trace.kernel_tables(scene), trace.frame_tables(scene)
    n_clusters = kt.planes.shape[0] // 32
    assert cs.walk_bytes(kt, n_clusters, 32 * n_clusters) == cs.table_bytes(kt)
    assert cs.walk_bytes(kt, n_clusters, 32 * n_clusters, ft) == cs.table_bytes(kt, ft)
    base = cs.walk_bytes(kt, 0, 0)
    assert cs.walk_bytes(kt, 1, 0) - base == 32 * 12 * 4
    assert cs.walk_bytes(kt, 0, 1) - base == 16 * 4
    g = torch.Generator().manual_seed(0)
    o = torch.rand(3, 512, generator=g) * 2.0 - 1.0 + torch.tensor([0.0, 0.5, 6.0])[:, None]
    d = torch.tensor([0.0, -0.05, -1.0])[:, None] + 0.3 * torch.randn(3, 512, generator=g)
    d = d / torch.linalg.vector_norm(d, dim=0, keepdim=True)
    out = trace.trace_plain(kt, torch.cat([o, d]).contiguous())
    clusters, slots = cs.winners(out)
    won = set(out[3].view(torch.int32)[out[0].abs() < 1e30].tolist())
    assert slots == len(won) > 0
    assert clusters == len({s // 32 for s in won}) <= n_clusters
