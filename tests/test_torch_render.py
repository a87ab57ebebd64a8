"""The port's frame (plain versions, on the CPU) against the JAX
``render_frame`` on the same scene and camera; the post chain against the
JAX post chain; the options this slice does not port; and that the port
loads neither JAX nor the JAX package."""

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


@pytest.mark.parametrize(
    "option",
    [
        dict(samples=2),
        dict(enable_fxaa=True),
        dict(enable_shadows=True),
        dict(enable_gi=True),
        dict(enable_refraction=True),
        dict(reference_parity_shading=False),
        dict(integer_colors=False),
    ],
    ids=lambda o: next(iter(o)),
)
def test_unported_options_raise(option, port_procedural):
    with pytest.raises(NotImplementedError):
        _port_frame(port_procedural, 8, 8, **option)


def test_imported_texture_scene_raises(two_instance_scene):
    port = scene_from_numpy(*flatten(two_instance_scene), device="cpu")
    with pytest.raises(NotImplementedError):
        _port_frame(port, 8, 8)


def test_too_many_materials_raise():
    from clraytracer_tpu_torch.scene import SceneBuilder
    from clraytracer_tpu_torch.scene.procedural import cube

    b = SceneBuilder()
    for _ in range(render_fused.MAX_FUSED_MATERIALS):
        b.create_material()
    b.add_instance(b.add_mesh(cube(1.0)))
    scene = b.build(device="cpu")
    assert scene.materials.count > render_fused.MAX_FUSED_MATERIALS
    with pytest.raises(NotImplementedError):
        _port_frame(scene, 8, 8)


def test_cpu_frame_launches_no_kernel(port_procedural):
    before = (render_fused.render_cuda.launches, trace.trace_cuda.launches)
    img = _port_frame(port_procedural, 16, 8)
    assert img.shape == (8, 16, 3)
    assert (render_fused.render_cuda.launches, trace.trace_cuda.launches) == before


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
        "from clraytracer_tpu_torch.diff import image_loss_and_grads\n"
        "from clraytracer_tpu_torch.render import frame_inputs_from_camera\n"
        "from clraytracer_tpu_torch import cli\n"
        "loss, g = image_loss_and_grads(s, frame_inputs_from_camera(cam, -1.96),\n"
        "                               32, 24, device='cpu')\n"
        "assert g['materials.albedo'].abs().max() > 0, g\n"
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
