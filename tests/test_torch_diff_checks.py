"""The port's own checks of its differentiable step, on the CPU: finite
differences of albedo, texel and vertex gradients (as tests/test_diff.py
checks the JAX package's), the deferred texel gather against per-bounce
gathers, the ``fit`` CLI, and the options it does not port."""

import dataclasses

import numpy as np
import pytest
import torch

from clraytracer_tpu_torch import diff as tdiff
from clraytracer_tpu_torch import render as trender
from clraytracer_tpu_torch.ops import gather_rows
from clraytracer_tpu_torch.ops import trace as ttrace
from test_torch_diff import _port, _port_frame, _port_loss_grads, _weights


@pytest.fixture(scope="module")
def fd_scenes():
    """tests/test_diff.py's scenes: a checker-textured sphere (imported
    textures), and the same sphere with a constant albedo for the vertex
    check (point sampling's plateaus would pollute its difference)."""
    from clraytracer_tpu.scene import SceneBuilder
    from clraytracer_tpu.scene.procedural import uv_sphere
    from clraytracer_tpu.scene.textures import checkerboard, gradient_sky

    out = []
    for textured in (True, False):
        b = SceneBuilder()
        b.import_texture(gradient_sky(64, 32))
        kw = {}
        if textured:
            kw = dict(albedo_tex=b.import_texture(
                checkerboard(8, 2, (255, 200, 150), (90, 110, 130))
            ), shininess=1.0, roughness=0.4)
        mat = b.create_material(albedo=(0.8, 0.55, 0.3), **kw)
        b.add_instance(b.add_mesh(uv_sphere(2.0, n_lat=6, n_lon=8), materials_start=mat))
        out.append(_port(b.build()))
    return out


FD_W, FD_H = 16, 12


def _fd_check(scene, group, field, eps, rtol, atol):
    weights = _weights(FD_H, FD_W)
    _, grads = _port_loss_grads(scene, weights, FD_W, FD_H)
    g = grads[f"{group}.{field}"].float().numpy()
    pos = np.unravel_index(np.abs(g).argmax(), g.shape)
    wt = torch.from_numpy(weights)

    def loss(sign):
        leaf = getattr(getattr(scene, group), field).clone()
        leaf[pos] += sign * eps
        grp = dataclasses.replace(getattr(scene, group), **{field: leaf})
        img = tdiff.render_image_diff(
            dataclasses.replace(scene, **{group: grp}), _port_frame(FD_W, FD_H),
            FD_W, FD_H, device="cpu",
        )
        return float(torch.sum(img * wt))

    fd = (loss(+1) - loss(-1)) / (2 * eps)
    np.testing.assert_allclose(fd, g[pos], rtol=rtol, atol=atol)


def test_albedo_gradient_matches_finite_difference(fd_scenes):
    _fd_check(fd_scenes[0], "materials", "albedo", 1e-3, 5e-2, 1e-4)


def test_texel_gradient_matches_finite_difference(fd_scenes):
    _fd_check(fd_scenes[0], "atlas", "texels", 1e-3, 5e-2, 1e-4)


def test_vertex_gradient_matches_finite_difference(fd_scenes):
    _fd_check(fd_scenes[1], "tris", "v0", 2e-3, 8e-2, 5e-4)


def test_deferred_texels_match_per_bounce(sphere_scene, monkeypatch):
    """The combined after-loop texel gather (render.bounce_loop) against a
    texel gather in every bounce: images and texel gradients."""
    scene = _port(sphere_scene)
    w, h = 48, 32
    weights = _weights(h, w)
    img_d = tdiff.render_image_diff(scene, _port_frame(w, h), w, h, device="cpu")
    _, g_d = _port_loss_grads(scene, weights, w, h)
    monkeypatch.setattr(trender, "_DEFER_TEXELS", False)
    img_0 = tdiff.render_image_diff(scene, _port_frame(w, h), w, h, device="cpu")
    _, g_0 = _port_loss_grads(scene, weights, w, h)
    np.testing.assert_allclose(img_d.detach().numpy(), img_0.detach().numpy(),
                               rtol=1e-5, atol=1e-5)
    assert g_d["atlas.texels"].abs().max() > 0.0
    np.testing.assert_allclose(g_d["atlas.texels"].numpy(), g_0["atlas.texels"].numpy(),
                               rtol=1e-5, atol=1e-6)


def test_fit_cli_recovers_albedo(capsys):
    """The Adam inverse-rendering loop (cli fit) on ``two``: the image loss
    falls by more than 10x in 40 steps and the albedo moves towards the
    truth."""
    import json

    from clraytracer_tpu_torch.cli import main

    argv = ["fit", "--scene", "two", "--width", "32", "--height", "24",
            "--steps", "40", "--lr", "0.08", "--device", "cpu"]
    assert main(argv) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["loss_last"] < report["loss_first"] * 0.1
    assert report["param_mae_final"] < report["param_mae_init"]


def test_grads_cli_report(capsys):
    """cli grads: the L2 loss against black and four gradient norms; the
    texel norm is zero on an all-procedural scene, the others are not."""
    import json

    from clraytracer_tpu_torch.cli import main

    argv = ["grads", "--scene", "two", "--width", "24", "--height", "16",
            "--device", "cpu"]
    assert main(argv) == 0
    report = json.loads(capsys.readouterr().out)
    norms = report["grad_norms"]
    assert report["loss"] > 0.0 and norms["atlas.texels"] == 0.0
    for key in ("materials.albedo", "tris.v0", "instances.inverse_transform"):
        assert 0.0 < norms[key] < float("inf"), key


def test_fit_texels_of_procedural_scene_raises():
    from clraytracer_tpu_torch.cli import build_scene, fit

    scene = build_scene("two", device="cpu")
    with pytest.raises(ValueError):
        fit(scene, _port_frame(8, 8), 8, 8, param="texels", steps=1, device="cpu")


def test_unported_options_raise(procedural_scene):
    scene = _port(procedural_scene)
    with pytest.raises(NotImplementedError):
        tdiff.render_image_diff(scene, _port_frame(8, 8), 8, 8, enable_post=True,
                                device="cpu")


def test_cpu_step_launches_no_kernel(procedural_scene):
    counters = lambda: (
        ttrace.trace_cuda.launches, gather_rows.gather_rows_cuda.launches,
        gather_rows.scatter_rows_cuda.launches,
    )
    before = counters()
    loss, grads = _port_loss_grads(_port(procedural_scene), w=16, h=8)
    assert np.isfinite(float(loss)) and grads["tris.v0"].abs().max() > 0.0
    assert counters() == before
