"""The frame finish on the CPU: the plain tail (``render_fused._finish``:
``_finish_frame``, then ``post_image``), which is the finish kernel's plain
version, against the JAX package's tail on the same K2.2 planes, in the
kernel's output layouts; and a CPU frame launches no finish kernel and
still opens the post chain's spans.

The JAX tail is ``render_pallas._finish_frame`` (render_pallas.py:936) on
the planes in its own tile-major layout, then its ``post_process_tiled``
and ``_untile``. The planes come from the port's plain K2.2
(``render_fused_plain``) on a ragged 40x20 frame of the shadow test's
ground scene (sky, a checkered ground, a sphere: hits and misses at both
bounces), in each atlas mode, with GI off and on. The radiance is equal
bit for bit; the finished image within 1e-6.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import jax.numpy as jnp

from clraytracer_tpu.ops import render_pallas as jrp
from clraytracer_tpu.ops.post import post_process_tiled as j_post_tiled
from clraytracer_tpu.render import _untile as j_untile
from clraytracer_tpu_torch import render as trender
from clraytracer_tpu_torch.camera import Camera
from clraytracer_tpu_torch.config import CameraConfig, RenderConfig
from clraytracer_tpu_torch.ops import render_fused as rf
from clraytracer_tpu_torch.ops.trace import frame_tables, kernel_tables
from clraytracer_tpu_torch.scene.bridge import scene_from_numpy
from test_torch_options import VIEWS, _ground_scene
from test_torch_scene import flatten

W, H = 40, 20  # one 128-lane tile across, three strips of 8 rows down: both ragged
_scenes: dict = {}


def _scene(atlas: bool):
    """(JAX scene, the port's copy through the bridge), built once."""
    if atlas not in _scenes:
        js = _ground_scene(atlas)
        _scenes[atlas] = (js, scene_from_numpy(*flatten(js), device="cpu"))
    return _scenes[atlas]


def _frame():
    pos, pitch, sun = VIEWS["ground"]
    cam = Camera.create(CameraConfig(position=pos, pitch_deg=pitch), W, H)
    return trender.frame_inputs_from_camera(cam, sun)


@pytest.mark.parametrize("mode,gi", [(m, gi) for m in (0, 1, 2) for gi in (False, True)])
def test_plain_finish_matches_jax_tail(mode, gi):
    js, ts = _scene(mode != 0)
    trows = rf.tile_rows(W * H)
    tiles_x, tiles_y = -(-W // 128), -(-H // trows)
    rows_total = tiles_x * tiles_y * trows
    layout = ("strip", trows, tiles_x, tiles_y)
    ft = frame_tables(ts)
    out = rf.render_fused_plain(
        kernel_tables(ts), ft, rf.camera_row(_frame()), W, H, trows, rows_total, 2,
        torch.device("cpu"), atlas_mode=mode, gi_seed=4 if gi else None,
    ).reshape(-1, rows_total, 128)
    planes = out.numpy()
    assert (planes[3:6] > 0).any() and (planes[0:3] > 0).any()  # misses and hits

    radiance = rf._finish(ts, ft, out, mode, gi)
    image = rf._finish(ts, ft, out, mode, gi, (W, H, layout))
    assert tuple(radiance.shape) == (3, rows_total, 128)
    assert tuple(image.shape) == (H, W, 3)

    # the JAX tail on the same planes, the deferred ones in its tile-major
    # [tiles, K*B*trows, 128] layout
    k = rf.deferred_planes(mode, gi)
    extra = None
    if k:
        extra = jnp.asarray(planes[9:].reshape(2 * k, tiles_x * tiles_y, trows, 128)
                            .transpose(1, 0, 2, 3).reshape(tiles_x * tiles_y, -1, 128))
    ref = jrp._finish_frame(js, *(jnp.asarray(planes[c:c + 3]) for c in (0, 3, 6)), extra,
                            tiles_x * tiles_y, trows, 2, mode, gi)
    ref_image = j_untile(j_post_tiled(ref, W, H, layout), layout, H, W).transpose(1, 2, 0)
    np.testing.assert_array_equal(radiance.numpy(), np.asarray(ref))
    # the post chain's pow and sqrt are XLA's on one side and torch's on the
    # other: within an ulp (test_torch_render.py's tiled post, 1e-6)
    np.testing.assert_allclose(image.numpy(), np.asarray(ref_image), rtol=0, atol=1e-6)


def _cpu_frame():
    _js, ts = _scene(True)
    return trender.render_frame(ts, _frame(), RenderConfig(width=W, height=H), device="cpu")


def test_cpu_frame_launches_no_finish_kernel():
    before = (rf.finish_cuda.launches, dict(rf.finish_cuda.variant_launches))
    img = _cpu_frame()
    assert tuple(img.shape) == (H, W, 3) and torch.isfinite(img).all()
    assert (rf.finish_cuda.launches, rf.finish_cuda.variant_launches) == before


def test_cpu_frame_opens_the_post_spans():
    _cpu_frame()  # the scene's tables
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _cpu_frame()
    names = [e.name for e in prof.events()]
    for span in ("render.finish", "render.post", "render.untile"):
        assert names.count(span) == 1, span
