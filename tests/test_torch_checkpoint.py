"""``.clsnap.npz`` snapshots across the two packages and the port's CLI
scene sources against the JAX CLI, on the CPU: a snapshot written by
either package loads in the other leaf for leaf and renders the same
frame; a version mismatch raises; ``render --scene`` of a snapshot, an
OBJ and a ``.clm`` gives the JAX CLI's image; ``inspect`` prints the JAX
CLI's JSON; ``snapshot`` writes what the JAX loader reads; ``fit
--save-snapshot`` writes the fitted scene."""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from clraytracer_tpu.camera import Camera as JCamera
from clraytracer_tpu.config import CameraConfig as JCameraConfig
from clraytracer_tpu.config import RenderConfig as JRenderConfig
from clraytracer_tpu.ops.trace_wavefront import trace_wavefront as j_wavefront
from clraytracer_tpu.render import frame_inputs_from_camera as j_frame_inputs
from clraytracer_tpu.render import render_frame as j_render_frame
from clraytracer_tpu.scene import checkpoint as j_ckpt
from clraytracer_tpu_torch import cli as tcli
from clraytracer_tpu_torch import render as trender
from clraytracer_tpu_torch.camera import Camera as TCamera
from clraytracer_tpu_torch.config import CameraConfig as TCameraConfig
from clraytracer_tpu_torch.config import RenderConfig as TRenderConfig
from clraytracer_tpu_torch.scene import checkpoint as t_ckpt
from clraytracer_tpu_torch.scene.bridge import scene_from_numpy
from test_scene import MTL_FIXTURE
from test_torch_scene import assert_leaves_equal, flatten

W, H = 32, 24
CAMERA = (0.13, 0.21, 10.0)


def _port_frame(scene, tracer=trender.trace_best):
    cam = TCamera.create(TCameraConfig(position=CAMERA), W, H)
    frame = trender.frame_inputs_from_camera(cam, -1.96)
    return trender.render_frame(scene, frame, TRenderConfig(width=W, height=H),
                                device="cpu", tracer=tracer).numpy()


@pytest.mark.parametrize("fixture", ["procedural_scene", "sphere_scene"])
def test_snapshots_cross_packages(fixture, request, tmp_path):
    """JAX snapshot → port: every leaf (procedural-texture descriptors and
    nested tuples included; the JAX-only ``clusters.geo_stream`` dropped)
    and a bit-equal frame; port snapshot → JAX: every leaf, and the JAX
    frame through ``trace_wavefront`` within 1e-5 of the port's on 99% of
    pixels."""
    jscene = request.getfixturevalue(fixture)
    arrays, static = flatten(jscene)
    port = scene_from_numpy(arrays, static, device="cpu")
    streamed = dataclasses.replace(
        jscene, clusters=dataclasses.replace(jscene.clusters,
                                             geo_stream=jnp.zeros((2, 128), jnp.float32)))
    j_ckpt.save_scene(streamed, tmp_path / "j.clsnap.npz", extras={"sun": -1.96})
    back, extras = t_ckpt.load_scene(tmp_path / "j.clsnap.npz", device="cpu")
    assert extras == {"sun": -1.96}
    assert back.clusters.geo_stream is None
    assert_leaves_equal(arrays, static, back)
    np.testing.assert_array_equal(_port_frame(back), _port_frame(port))

    t_ckpt.save_scene(port, tmp_path / "t.clsnap.npz", extras={"step": 3})
    jback, jextras = j_ckpt.load_scene(tmp_path / "t.clsnap.npz")
    assert jextras == {"step": 3}
    assert jback.clusters.geo_stream is None
    assert_leaves_equal(*flatten(jback), port)
    jcam = JCamera.create(JCameraConfig(position=CAMERA), W, H)
    ref = np.asarray(j_render_frame(jback, j_frame_inputs(jcam, -1.96),
                                    JRenderConfig(width=W, height=H), tracer=j_wavefront))
    got = _port_frame(back, trender.trace_wavefront)
    bad = (np.abs(got - ref) > 1e-5).any(axis=-1)
    assert bad.mean() <= 0.01


def test_snapshot_version_mismatch_raises(procedural_scene, tmp_path):
    port = scene_from_numpy(*flatten(procedural_scene), device="cpu")
    path = t_ckpt.save_scene(port, tmp_path / "s.clsnap.npz")
    with np.load(path) as z:
        items = {k: z[k] for k in z.files}
    meta = json.loads(bytes(items["__meta__"]).decode())
    meta["version"] = t_ckpt.CHECKPOINT_VERSION + 1
    items["__meta__"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    with open(tmp_path / "old.clsnap.npz", "wb") as f:
        np.savez_compressed(f, **items)
    with pytest.raises(ValueError, match="checkpoint version"):
        t_ckpt.load_scene(tmp_path / "old.clsnap.npz", device="cpu")
    # a required field the file lacks fails loudly too
    del items["a:scene.tris.v0"]
    meta["version"] = t_ckpt.CHECKPOINT_VERSION
    items["__meta__"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    with open(tmp_path / "short.clsnap.npz", "wb") as f:
        np.savez_compressed(f, **items)
    with pytest.raises(ValueError, match="missing required field"):
        t_ckpt.load_scene(tmp_path / "short.clsnap.npz", device="cpu")


@pytest.fixture(scope="module")
def scene_files(tmp_path_factory):
    """An OBJ with an MTL and a PNG diffuse map, its ``.clm``, and the JAX
    CLI's snapshot of it."""
    from PIL import Image

    from clraytracer_tpu.cli import main as jmain
    from clraytracer_tpu.scene.clm import save_clm
    from clraytracer_tpu.scene.obj import load_obj
    from clraytracer_tpu_torch.scene.procedural import uv_sphere

    d = tmp_path_factory.mktemp("scene")
    m = uv_sphere(2.0, 8, 12)
    lines = ["mtllib fixture.mtl", "usemtl red"]
    for k in range(m.count):
        for a in ("v0", "v1", "v2"):
            lines.append("v %.6f %.6f %.6f" % tuple(getattr(m, a)[k]))
        for a in ("uv0", "uv1", "uv2"):
            lines.append("vt %.6f %.6f" % tuple(getattr(m, a)[k]))
        for a in ("n0", "n1", "n2"):
            lines.append("vn %.6f %.6f %.6f" % tuple(getattr(m, a)[k]))
        b = 3 * k + 1
        if k == m.count // 2:
            lines.append("usemtl blue")
        lines.append(f"f {b}/{b}/{b} {b + 1}/{b + 1}/{b + 1} {b + 2}/{b + 2}/{b + 2}")
    (d / "fixture.obj").write_text("\n".join(lines) + "\n")
    (d / "fixture.mtl").write_text(MTL_FIXTURE)
    rng = np.random.default_rng(4)
    Image.fromarray(rng.integers(0, 256, (16, 16, 3), dtype=np.uint8)).save(d / "red.png")
    save_clm(d / "fixture.clm", load_obj(d / "fixture.obj"))
    assert jmain(["snapshot", "--scene", str(d / "fixture.obj"),
                  "-o", str(d / "fixture.clsnap.npz")]) == 0
    return {"obj": d / "fixture.obj", "clm": d / "fixture.clm",
            "clsnap": d / "fixture.clsnap.npz"}


@pytest.mark.parametrize("source", ["clsnap", "obj", "clm"])
def test_cli_render_scene_file_matches_jax_cli(source, scene_files, tmp_path):
    """``render --scene <file> --tracer wavefront`` of each scene source
    at 16x12: the port's PNG (``--device cpu``) within 1/255 of the JAX
    CLI's."""
    from PIL import Image

    from clraytracer_tpu.cli import main as jmain

    args = ["render", "--scene", str(scene_files[source]), "--width", "16",
            "--height", "12", "--tracer", "wavefront"]
    assert jmain(args + ["-o", str(tmp_path / "j.png")]) == 0
    assert tcli.main(args + ["--device", "cpu", "-o", str(tmp_path / "t.png")]) == 0
    ref = np.asarray(Image.open(tmp_path / "j.png"), np.int16)
    got = np.asarray(Image.open(tmp_path / "t.png"), np.int16)
    assert got.shape == ref.shape == (12, 16, 3)
    assert np.abs(got - ref).max() <= 1
    assert ref.std() > 0  # the sphere is in view


def test_cli_inspect_and_snapshot_match_jax_cli(scene_files, tmp_path, capsys):
    """``inspect`` prints the JAX CLI's JSON; the port's ``snapshot``
    loads in the JAX package with the leaves the port built; an unknown
    tracer name is refused."""
    from clraytracer_tpu.cli import main as jmain

    for path in scene_files.values():
        assert jmain(["inspect", "--scene", str(path)]) == 0
        ref = json.loads(capsys.readouterr().out)
        assert tcli.main(["inspect", "--scene", str(path), "--device", "cpu"]) == 0
        assert json.loads(capsys.readouterr().out) == ref
    out = tmp_path / "t.clsnap.npz"
    assert tcli.main(["snapshot", "--scene", str(scene_files["obj"]), "--device", "cpu",
                      "-o", str(out)]) == 0
    jback, _ = j_ckpt.load_scene(out)
    assert_leaves_equal(*flatten(jback), tcli.build_scene(str(scene_files["obj"]),
                                                          device="cpu"))
    with pytest.raises(SystemExit):
        tcli.main(["render", "--scene", "two", "--tracer", "nope", "--device", "cpu"])
    with pytest.raises(SystemExit, match="museum scene needs the reference assets"):
        tcli.build_scene("museum", device="cpu")


def test_cli_fit_save_snapshot(tmp_path):
    """``fit --save-snapshot`` writes the fitted scene with the fit report
    as extras; the snapshot renders through ``--scene``."""
    out = tmp_path / "fit.clsnap.npz"
    assert tcli.main(["fit", "--scene", "two", "--width", "16", "--height", "12",
                      "--steps", "3", "--lr", "0.08", "--device", "cpu",
                      "--save-snapshot", str(out)]) == 0
    fitted, extras = t_ckpt.load_scene(out, device="cpu")
    assert extras["fit"]["steps"] == 3 and extras["fit"]["param"] == "albedo"
    true = tcli.build_scene("two", device="cpu")
    assert not torch.equal(fitted.materials.albedo, true.materials.albedo)
    assert torch.equal(fitted.tris.v0, true.tris.v0)
    assert tcli.main(["render", "--scene", str(out), "--width", "16", "--height", "12",
                      "--device", "cpu", "-o", str(tmp_path / "f.png")]) == 0
