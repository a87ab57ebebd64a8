"""The port's scene import layer against the JAX package's, on the CPU:
``parse_mtl`` and ``load_obj`` (native and Python parsers) on
tests/test_scene.py's fixtures, ``.clm`` files and QuickLZ streams byte
for byte in both directions, the ``.clmz`` cache, ``resolve_asset_path``,
the leaves ``SceneBuilder.import_mesh`` + ``build()`` give, and the
port's own image decoder (PIL hidden) against PIL's decode."""

import dataclasses
import sys

import numpy as np
import pytest

from clraytracer_tpu.scene import cache as j_cache
from clraytracer_tpu.scene import clm as j_clm
from clraytracer_tpu.scene import obj as j_obj
from clraytracer_tpu_torch.scene import cache as t_cache
from clraytracer_tpu_torch.scene import clm as t_clm
from clraytracer_tpu_torch.scene import imagefile
from clraytracer_tpu_torch.scene import obj as t_obj
from clraytracer_tpu_torch.scene import textures as t_textures
from _torch_ties import package
from test_scene import MTL_FIXTURE, OBJ_FIXTURE
from test_torch_scene import assert_leaves_equal, flatten

MESH_FIELDS = ("v0", "v1", "v2", "uv0", "uv1", "uv2", "n0", "n1", "n2", "mat_idx")
QUAD_FAN = "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nf 1 2 3 4\n"


def assert_obj_equal(a, b):
    """Two ObjMesh (of either package) field for field."""
    for f in MESH_FIELDS:
        x, y = getattr(a.mesh, f), getattr(b.mesh, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    assert len(a.materials) == len(b.materials)
    for ma, mb in zip(a.materials, b.materials):
        for f in ("name", "shininess", "roughness", "diffuse_map", "specular_map"):
            assert getattr(ma, f) == getattr(mb, f), f
        np.testing.assert_array_equal(ma.diffuse, mb.diffuse)
        np.testing.assert_array_equal(ma.specular, mb.specular)


def test_parse_mtl_matches_jax():
    ref, got = j_obj.parse_mtl(MTL_FIXTURE), t_obj.parse_mtl(MTL_FIXTURE)
    assert [m.name for m in got] == ["red", "blue"]
    for a, b in zip(ref, got):
        assert dataclasses.asdict(a).keys() == dataclasses.asdict(b).keys()
        for f in ("name", "shininess", "roughness", "diffuse_map", "specular_map"):
            assert getattr(a, f) == getattr(b, f), f
        np.testing.assert_array_equal(a.diffuse, b.diffuse)
        np.testing.assert_array_equal(a.specular, b.specular)


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
@pytest.mark.parametrize("fixture", ["fixture", "quad_fan"])
def test_load_obj_matches_jax(fixture, native, tmp_path):
    """Each parser of the port gives its JAX twin's ObjMesh, and the port's
    native parser the port's Python parser's (tests/test_native.py:33)."""
    if fixture == "fixture":
        (tmp_path / "m.obj").write_text(OBJ_FIXTURE)
        (tmp_path / "m.mtl").write_text(MTL_FIXTURE)
    else:
        (tmp_path / "m.obj").write_text(QUAD_FAN)
    got = t_obj.load_obj(tmp_path / "m.obj", prefer_native=native)
    assert_obj_equal(j_obj.load_obj(tmp_path / "m.obj", prefer_native=native), got)
    assert_obj_equal(t_obj.load_obj(tmp_path / "m.obj", prefer_native=not native), got)
    assert got.mesh.count == 2
    if fixture == "quad_fan":  # fan triangulated, generated face normals
        np.testing.assert_allclose(np.abs(got.mesh.n0), [[0, 0, 1]] * 2, atol=1e-6)


def _random_obj(pkg_obj, pkg_proc, n: int, seed: int = 0):
    """tests/test_clm.py's ``_random_mesh`` for either package."""
    rng = np.random.default_rng(seed)
    verts = rng.normal(size=(3, n, 3)).astype(np.float32)
    uv = rng.uniform(size=(3, n, 2)).astype(np.float16).astype(np.float32)
    nrm = rng.normal(size=(3, n, 3)).astype(np.float16).astype(np.float32)
    mesh = pkg_proc.MeshData(
        v0=verts[0], v1=verts[1], v2=verts[2], uv0=uv[0], uv1=uv[1], uv2=uv[2],
        n0=nrm[0], n1=nrm[1], n2=nrm[2],
        mat_idx=rng.integers(0, 2, n).astype(np.int32),
    )
    mats = [
        pkg_obj.ObjMaterial(name="stone", diffuse=np.array([1.0, 0.5, 0.25], np.float32),
                            specular=np.array([0.2, 0.2, 0.2], np.float32),
                            shininess=0.5, roughness=0.75,
                            diffuse_map="Assets/demo/stone.JPG"),
        pkg_obj.ObjMaterial(name="flat", diffuse=np.array([0.0, 1.0, 0.0], np.float32),
                            specular=np.zeros(3, np.float32), shininess=1.0,
                            roughness=0.0, specular_map="spec.png"),
    ]
    return pkg_obj.ObjMesh(mesh=mesh, materials=mats)


@pytest.mark.parametrize("n", [16, 3000])  # raw and QuickLZ-compressed tri blobs
def test_clm_files_cross_packages(n, tmp_path):
    """A ``.clm`` the port writes is byte-equal to the JAX package's, and
    each package reads the other's file to the same ObjMesh."""
    from clraytracer_tpu.scene import procedural as j_proc
    from clraytracer_tpu_torch.scene import procedural as t_proc

    j_clm.save_clm(tmp_path / "j.clm", _random_obj(j_obj, j_proc, n))
    t_clm.save_clm(tmp_path / "t.clm", _random_obj(t_obj, t_proc, n))
    assert (tmp_path / "t.clm").read_bytes() == (tmp_path / "j.clm").read_bytes()
    assert_obj_equal(j_clm.load_clm(tmp_path / "t.clm"), t_clm.load_clm(tmp_path / "j.clm"))
    back = t_clm.load_clm(tmp_path / "j.clm")
    assert back.mesh.count == n
    assert back.materials[0].diffuse_map == "Assets/demo/stone.JPG"


def _compressible(n: int, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    buf = np.tile(rng.integers(0, 256, 80, dtype=np.uint8), n // 80 + 1)[:n]
    idx = rng.integers(0, max(n, 1), max(n // 7, 1))
    buf[idx] = rng.integers(0, 256, idx.size, dtype=np.uint8)
    return buf.tobytes()


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_qlz_bytes_match_jax(native, monkeypatch):
    """The port's QuickLZ compressor (native, and its Python mirror with
    the library hidden) gives the JAX package's bytes, stored-block
    fallback included, and both decoders of the port read them."""
    from clraytracer_tpu_torch.runtime import build

    if not native:
        monkeypatch.setattr(build, "_lib", None)
        monkeypatch.setattr(build, "_tried", True)
    else:
        assert build.native_lib() is not None
    payloads = [_compressible(n, s) for n, s in ((16, 0), (216, 1), (5000, 2), (77_777, 3))]
    payloads += [np.random.default_rng(7).integers(0, 256, 4096, np.uint8).tobytes(),
                 bytes(1000)]
    for payload in payloads:
        got = t_clm.qlz_compress(payload)
        assert got == j_clm.qlz_compress(payload), len(payload)
        assert t_clm.qlz_decompress(got, len(payload)) == payload
        assert t_clm._qlz_decompress_py(got, len(payload)) == payload
    assert t_clm._qlz_compress_py(payloads[2]) == j_clm._qlz_compress_py(payloads[2])


def test_mesh_cache_and_asset_paths(tmp_path):
    """``.clmz`` caches read across packages; ``import_mesh`` takes a
    ``.clm`` directly, a sibling ``.clm`` for an absent OBJ, and a fresh
    cache over the OBJ; ``resolve_asset_path`` folds case and prefixes as
    the JAX one does."""
    (tmp_path / "fixture.obj").write_text(OBJ_FIXTURE)
    (tmp_path / "fixture.mtl").write_text(MTL_FIXTURE)
    obj = t_obj.load_obj(tmp_path / "fixture.obj")
    t_cache.save_mesh_cache(tmp_path / "fixture.obj", obj)
    assert_obj_equal(j_cache.load_mesh_cache(tmp_path / "fixture.clmz"), obj)
    j_cache.save_mesh_cache(tmp_path / "fixture.obj", j_obj.load_obj(tmp_path / "fixture.obj"))
    assert_obj_equal(t_cache.load_mesh_cache(tmp_path / "fixture.clmz"), obj)
    # the cache wins while the OBJ is not newer: edit the cached copy
    edited = t_cache.load_mesh_cache(tmp_path / "fixture.clmz")
    edited.materials[0].name = "from-cache"
    t_cache.save_mesh_cache(tmp_path / "fixture.obj", edited)
    assert t_cache.import_mesh(tmp_path / "fixture.obj").materials[0].name == "from-cache"
    assert t_cache.import_mesh(tmp_path / "fixture.obj", use_cache=False).materials[0].name == "red"
    t_clm.save_clm(tmp_path / "m.clm", obj)
    assert t_cache.import_mesh(tmp_path / "m.clm").mesh.count == 2
    assert t_cache.import_mesh(tmp_path / "m.obj").mesh.count == 2  # sibling .clm
    (tmp_path / "Tex").mkdir()
    (tmp_path / "Tex" / "Stone.JPG").write_bytes(b"x")
    for rel in ("Assets/scene/tex/stone.jpg", "absent/nothere.png", "tex\\STONE.jpg"):
        assert t_clm.resolve_asset_path(tmp_path, rel) == j_clm.resolve_asset_path(tmp_path, rel)
    assert t_clm.resolve_asset_path(tmp_path, "Assets/x/tex/stone.jpg") == (
        tmp_path / "Tex" / "Stone.JPG")


def _textured_obj(tmp_path):
    """An OBJ/MTL pair with quads, three usemtl groups, a diffuse and a
    specular PNG map and one missing map."""
    from PIL import Image

    rng = np.random.default_rng(5)
    Image.fromarray(rng.integers(0, 256, (12, 20, 3), dtype=np.uint8)).save(tmp_path / "d.png")
    Image.fromarray(rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)).save(tmp_path / "s.png")
    lines = ["mtllib scene.mtl"]
    for k in range(6):  # a strip of 6 quads, some bent up
        for x in (k, k + 1):
            lines.append(f"v {x} {0.3 * (k % 2)} 0")
            lines.append(f"v {x} {0.3 * (k % 2)} -1")
    lines += ["vt 0 0", "vt 1 0", "vt 1 1", "vt 0 1", "vn 0 1 0", "vn 0 0.8 0.6"]
    for k in range(6):
        a = 4 * k + 1
        if k % 3 == 0:
            lines.append(["usemtl wood", "usemtl metal", "usemtl plain"][k // 3 % 3])
        lines.append(f"f {a}/1/1 {a + 2}/2/1 {a + 3}/3/2 {a + 1}/4/2")
    lines.append("usemtl plain")
    lines.append("f 1/1/1 3/2/1 4/3/1")
    (tmp_path / "scene.obj").write_text("\n".join(lines) + "\n")
    (tmp_path / "scene.mtl").write_text(
        "newmtl wood\nKd 0.8 0.6 0.4\nNs 30\nmap_Kd D.PNG\nmap_Ks s.png\n"
        "newmtl metal\nKd 0.5 0.5 0.6\nKs 0.9 0.9 0.9\nd 0.2\nmap_Kd missing.png\n"
        "newmtl plain\nKd 0.3 0.7 0.3\n"
    )
    return tmp_path / "scene.obj"


@pytest.mark.parametrize("source", ["obj", "clm"])
def test_import_mesh_build_matches_jax(source, tmp_path, monkeypatch):
    """``import_mesh`` + ``build()``: every leaf equal to the JAX builder's
    (cluster and packed tables, f16 attributes, material block offsets,
    textures), the OBJ imported twice beside a procedural mesh, once
    through its ``.clm``; the port with PIL hidden (its own decoder)."""
    path = _textured_obj(tmp_path)
    if source == "clm":
        t_clm.save_clm(tmp_path / "scene.clm", t_obj.load_obj(path))
        path = tmp_path / "scene.clm"

    def recipe(pkg):
        b = pkg.SceneBuilder()
        b.import_procedural(pkg.ptex.sky_gradient(64, 32))
        m = b.import_mesh(path, use_cache=False)
        c = b.add_mesh(pkg.cube(0.5), materials_start=b.create_material(albedo=(0.1, 0.2, 0.9)))
        b.add_instance(m)
        b.add_instance(c, pkg.math3d.translation(1.0, 1.0, 0.0))
        b.add_instance(m, pkg.math3d.translation(0.0, 0.0, 3.0))
        return b

    jax_scene = recipe(package("clraytracer_tpu")).build()
    monkeypatch.setitem(sys.modules, "PIL", None)
    assert t_textures.image_decoder() == "port"
    port = recipe(package("clraytracer_tpu_torch")).build(device="cpu")
    assert port.atlas.num_textures == 5  # white, black, sky, D.PNG, s.png
    assert port.materials.count == 5
    assert_leaves_equal(*flatten(jax_scene), port)


def _write_pil(path, mode, seed=0):
    from PIL import Image

    rng = np.random.default_rng(seed)
    rgb = rng.integers(0, 256, (13, 17, 3), dtype=np.uint8)
    rgb[:, :8] //= 7  # smooth regions, so the encoder picks several filters
    im = Image.fromarray(rgb)
    if mode == "P":
        im = im.quantize(64)  # an 8-bit palette (more than 16 colours)
    elif mode != "RGB":
        im = im.convert(mode)
    im.save(path)


@pytest.mark.parametrize("mode", ["L", "RGB", "P", "LA", "RGBA", "PPM", "filters"])
def test_load_image_without_pil_matches_pil(mode, tmp_path, monkeypatch):
    """The port's decoder (PIL hidden) against PIL's ``convert("RGB")`` on
    PNGs PIL writes in each colour type, a P6 file, and a PNG written with
    every row filter in turn (chip_smoke.png_bytes); native and Python
    unfilter alike."""
    from PIL import Image

    import chip_smoke
    from clraytracer_tpu_torch.runtime import build

    path = tmp_path / ("img.ppm" if mode == "PPM" else "img.png")
    if mode == "PPM":
        _write_pil(path, "RGB")
    elif mode == "filters":
        rgb = np.random.default_rng(2).integers(0, 256, (23, 19, 3), dtype=np.uint8)
        path.write_bytes(chip_smoke.png_bytes(rgb))
    else:
        _write_pil(path, mode)
    with Image.open(path) as im:
        ref = np.asarray(im.convert("RGB"), np.uint8)
    assert t_textures.decode_rgb8(path).tobytes() == ref.tobytes()  # through PIL
    monkeypatch.setitem(sys.modules, "PIL", None)
    assert t_textures.image_decoder() == "port"
    atlas = t_textures.AtlasBuilder()
    h = atlas.load_image(path)
    texels, w, hh, off = atlas.build()
    got = texels[off[h]: off[h] + w[h] * hh[h]].reshape(hh[h], w[h], 3)
    np.testing.assert_array_equal(got, ref)
    monkeypatch.setattr(build, "_lib", None)
    monkeypatch.setattr(build, "_tried", True)
    np.testing.assert_array_equal(imagefile.decode_image(path), ref)


@pytest.mark.parametrize("kind", ["jpeg", "png16", "interlaced", "bits4"])
def test_unsupported_image_raises(kind, tmp_path, monkeypatch):
    """Formats the port's decoder does not read raise an error naming the
    file and its format; none decodes to a placeholder."""
    from PIL import Image

    rgb = np.random.default_rng(0).integers(0, 256, (8, 8, 3), dtype=np.uint8)
    path = tmp_path / f"img.{'jpg' if kind == 'jpeg' else 'png'}"
    if kind == "jpeg":
        Image.fromarray(rgb).save(path)
    elif kind == "png16":
        Image.fromarray(rgb[..., 0].astype(np.uint16) * 257).save(path)
    elif kind == "interlaced":  # IHDR's interlace byte set to Adam7
        import struct
        import zlib

        import chip_smoke

        png = bytearray(chip_smoke.png_bytes(rgb))
        png[28] = 1  # signature 8 + length 4 + tag 4 + 12 bytes of fields
        png[29:33] = struct.pack(">I", zlib.crc32(bytes(png[12:29])) & 0xFFFFFFFF)
        path.write_bytes(bytes(png))
    else:
        Image.fromarray(rgb).quantize(8).save(path)  # a 4-bit palette
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(imagefile.UnsupportedImageError, match=str(path.name)):
        t_textures.AtlasBuilder().load_image(path)
