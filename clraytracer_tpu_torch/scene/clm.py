"""Reader and writer of the reference's ``.clm`` binary mesh caches (a copy
of the JAX package's ``scene/clm.py``: a file either package writes is
byte-equal and reads in the other).

The reference converts every imported OBJ into a ``.clm`` next to it and
prefers the cache on re-import (AssetManager.cpp:291-380). Its bundled
scenes — sponza, sibenik, nanosuit — ship ONLY as ``.clm``, so reading the
format is required to load them at all. Layout (little-endian, packed):

  u32   version            (CMeshVersion == 0, AssetManager.cpp:291)
  i32   numTris
  i32   numMaterials
  ObjMaterial[numMaterials]   24-byte records (AssetManager.hpp:5-10)
  u32   mtlTextSize
  char[mtlTextSize]           the .mtl text, name/path spans null-terminated
                              in place by the parser (AssetManager.cpp:143,180)
  tris  numTris < 1000 → raw Tri records (80 bytes, ResourceManager.hpp:54-67)
        else → u64 compressed size + one QuickLZ level-1 stream
        (AssetManager.cpp:306-318)

Decompression runs in the native runtime (runtime/native/qlz.cpp) with a
bit-identical pure-Python fallback below.
"""

from __future__ import annotations

import ctypes
import struct
from pathlib import Path

import numpy as np

from clraytracer_tpu_torch.scene.obj import ObjMaterial, ObjMesh
from clraytracer_tpu_torch.scene.procedural import MeshData

CLM_VERSION = 0

#: reference Tri, 80 bytes (ResourceManager.hpp:54-67): three xyz+centroid
#: float4 lanes, then half-precision uv/normal attributes + i16 material
TRI_DTYPE = np.dtype(
    [
        ("v0", "<f4", (4,)),
        ("v1", "<f4", (4,)),
        ("v2", "<f4", (4,)),
        ("uv0", "<f2", (2,)),
        ("uv1", "<f2", (2,)),
        ("uv2", "<f2", (2,)),
        ("mat", "<i2"),
        ("n0", "<f2", (3,)),
        ("n1", "<f2", (3,)),
        ("n2", "<f2", (3,)),
    ]
)
assert TRI_DTYPE.itemsize == 80

#: reference ObjMaterial (AssetManager.hpp:5-10): name/diffusePath/
#: specularPath are byte offsets into the embedded mtl text (0 = absent)
CLM_MATERIAL_DTYPE = np.dtype(
    [
        ("name", "<i4"),
        ("diffuse", "<u4"),
        ("specular", "<u4"),
        ("shininess", "<f2"),
        ("roughness", "<f2"),
        ("diffuse_path", "<i4"),
        ("specular_path", "<i4"),
    ]
)
assert CLM_MATERIAL_DTYPE.itemsize == 24


# -- QuickLZ level-1 containers ------------------------------------------------


def qlz_decompress(blob: bytes, expected_size: int | None = None) -> bytes:
    """Decode one QuickLZ container (levels: 1 or stored)."""
    from clraytracer_tpu_torch.runtime.build import native_lib

    if len(blob) < 3:
        raise ValueError("qlz container truncated")
    n = 4 if blob[0] & 2 else 1
    (dsize,) = struct.unpack_from("<I" if n == 4 else "<B", blob, 1 + n)
    if expected_size is not None and dsize != expected_size:
        raise ValueError(f"qlz size mismatch: header {dsize} != {expected_size}")

    lib = native_lib()
    if lib is not None:
        out = np.zeros(max(dsize, 1), np.uint8)
        src = np.frombuffer(blob, np.uint8)
        got = lib.clrt_qlz_decompress(
            src.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
            ctypes.c_longlong(len(blob)),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
            ctypes.c_longlong(dsize),
        )
        if got != dsize:
            raise ValueError(f"qlz decode failed (native rc {got})")
        return out.tobytes()
    return _qlz_decompress_py(blob, dsize)


def _qlz_decompress_py(blob: bytes, dsize: int) -> bytes:
    """Pure-Python mirror of runtime/native/qlz.cpp (slow path)."""
    flags = blob[0]
    n = 4 if flags & 2 else 1
    header = 1 + 2 * n
    csize = int.from_bytes(blob[1 : 1 + n], "little")
    if csize > len(blob) or csize < header:
        raise ValueError("qlz container truncated")
    if not flags & 1:  # stored
        return bytes(blob[header : header + dsize])
    if (flags >> 2) & 3 != 1:
        raise ValueError(f"unsupported qlz level {(flags >> 2) & 3}")

    src = blob
    i = header
    end = csize
    dst = bytearray(dsize)
    table = [0] * 4096
    d = 0
    hashed = -1
    cw = 1
    tail_start = dsize - 1 - 6 - 4
    lit_run = (4, 0, 1, 0, 2, 0, 1, 0, 3, 0, 1, 0, 2, 0, 1, 0)

    def record_upto(upto: int) -> None:
        nonlocal hashed
        while hashed < upto:
            hashed += 1
            f = dst[hashed] | dst[hashed + 1] << 8 | dst[hashed + 2] << 16
            table[((f >> 12) ^ f) & 0xFFF] = hashed

    while True:
        if cw == 1:
            if i + 4 > end:
                raise ValueError("qlz stream truncated (control word)")
            cw = int.from_bytes(src[i : i + 4], "little")
            i += 4
        if cw & 1:
            cw >>= 1
            tok = src[i] | src[i + 1] << 8
            frm = table[(tok >> 4) & 0xFFF]
            if tok & 0xF:
                ln = (tok & 0xF) + 2
                i += 2
            else:
                ln = src[i + 2]
                i += 3
            if d + ln > dsize or frm >= d:
                raise ValueError("qlz stream corrupt (match)")
            for k in range(ln):  # overlap-safe forward copy
                dst[d + k] = dst[frm + k]
            record_upto(d)
            d += ln
            hashed = d - 1
        elif d < tail_start:
            run = lit_run[cw & 0xF]
            dst[d : d + run] = src[i : i + run]
            cw >>= run
            d += run
            i += run
            record_upto(d - 3)
        else:
            while d < dsize:
                if cw == 1:
                    i += 4
                    cw = 1 << 31
                if i >= end:
                    raise ValueError("qlz stream truncated (tail)")
                dst[d] = src[i]
                d += 1
                i += 1
                cw >>= 1
            return bytes(dst)


def qlz_compress(payload: bytes) -> bytes:
    """Encode bytes as a level-1 QuickLZ container (wide header), matching
    the reference's own `.clm` tri-blob compression (AssetManager.cpp:310-318
    calls quicklz level 1 at >= 1000 tris). Falls back to the stored form
    whenever compression would not shrink the payload (tiny or
    incompressible inputs) — both forms are valid reference input."""
    from clraytracer_tpu_torch.runtime.build import native_lib

    if len(payload) >= 216:
        lib = native_lib()
        if lib is not None:
            src = np.frombuffer(payload, np.uint8)
            out = np.zeros(len(payload) + 400, np.uint8)
            got = lib.clrt_qlz_compress(
                src.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
                ctypes.c_longlong(len(payload)),
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
                ctypes.c_longlong(out.size),
            )
            if got > 0:
                return out[:got].tobytes()
        else:
            blob = _qlz_compress_py(payload)
            if blob is not None:
                return blob
    return qlz_store(payload)


def _qlz_compress_py(payload: bytes) -> bytes | None:
    """Pure-Python mirror of the native level-1 encoder (slow path).

    The hash table follows the DECODER's update discipline exactly (literal
    positions lazily up to cursor-3, each match's first position, bodies
    skipped), so both tables agree at every match token and all offsets are
    >= 3 by construction (the reference decoder's MINOFFSET check).
    Returns None when compression does not beat the stored form."""
    src = payload
    n = len(src)
    if n < 16 or n > 0xFFFFFFFF - 400:
        return None
    out = bytearray(9)
    table = [0] * 4096
    hashed = -1

    def hash3(p: int) -> int:
        f = src[p] | src[p + 1] << 8 | src[p + 2] << 16
        return ((f >> 12) ^ f) & 0xFFF

    def record_upto(upto: int) -> None:
        nonlocal hashed
        while hashed < upto:
            hashed += 1
            table[hash3(hashed)] = hashed

    cw_at = len(out)
    out += b"\0\0\0\0"
    cw_bits = 0
    cw_n = 0

    def put_flag(bit: int) -> None:
        nonlocal cw_at, cw_bits, cw_n
        if cw_n == 31:
            out[cw_at : cw_at + 4] = (cw_bits | 1 << 31).to_bytes(4, "little")
            cw_at = len(out)
            out.extend(b"\0\0\0\0")
            cw_bits = 0
            cw_n = 0
        cw_bits |= bit << cw_n
        cw_n += 1

    last_matchstart = n - 11
    pos = 0
    while pos < n:
        ln = 0
        h = 0
        if pos <= last_matchstart:
            h = hash3(pos)
            o = table[h]
            if o + 3 <= pos and src[o : o + 3] == src[pos : pos + 3]:
                cap = min(n - 5 - pos, 255)
                ln = 3
                while ln < cap and src[o + ln] == src[pos + ln]:
                    ln += 1
        if ln >= 3:
            put_flag(1)
            tok = h << 4 | (ln - 2 if ln <= 17 else 0)
            out.append(tok & 0xFF)
            out.append(tok >> 8)
            if ln > 17:
                out.append(ln)
            record_upto(pos)
            pos += ln
            hashed = pos - 1
        else:
            put_flag(0)
            out.append(src[pos])
            pos += 1
            record_upto(pos - 3)
    out[cw_at : cw_at + 4] = (cw_bits | 1 << cw_n).to_bytes(4, "little")
    if len(out) >= n + 9:
        return None
    out[0] = 0x47  # compressed | wide sizes | level 1 | quicklz bit 6
    out[1:5] = len(out).to_bytes(4, "little")
    out[5:9] = n.to_bytes(4, "little")
    return bytes(out)


def qlz_store(payload: bytes) -> bytes:
    """Wrap bytes in a stored (uncompressed) container the reference's
    qlz_decompress accepts — used when exporting reference-readable .clm."""
    total = len(payload) + 9
    return bytes([0b10]) + struct.pack("<II", total, len(payload)) + payload


# -- .clm container ------------------------------------------------------------


def _cstr(blob: bytes, off: int) -> str | None:
    """Null-terminated string at a mtl-text offset (0 = absent)."""
    if off <= 0 or off >= len(blob):
        return None
    nul = blob.find(b"\0", off)
    if nul < 0:
        nul = len(blob)
    return blob[off:nul].decode("utf-8", errors="replace")


def _unpack_rgb(c: int) -> np.ndarray:
    """PackColorRGBU32 inverse (Math.hpp:237-239): R in the low byte."""
    return np.array(
        [(c & 0xFF) / 255.0, (c >> 8 & 0xFF) / 255.0, (c >> 16 & 0xFF) / 255.0],
        np.float32,
    )


def load_clm(path: str | Path) -> ObjMesh:
    """Parse one reference ``.clm`` into an :class:`ObjMesh`.

    Texture paths come out as stored in the embedded mtl text (project-root
    relative, Windows case) — resolution happens at import time
    (:func:`resolve_asset_path`).
    """
    data = Path(path).read_bytes()
    version, num_tris, num_mats = struct.unpack_from("<Iii", data, 0)
    if version != CLM_VERSION:
        raise ValueError(f"unsupported .clm version {version} in {path}")
    if not 0 <= num_mats <= 32 or num_tris < 0:
        raise ValueError(f"corrupt .clm header in {path}")
    off = 12
    mats = np.frombuffer(data, CLM_MATERIAL_DTYPE, num_mats, off)
    off += num_mats * CLM_MATERIAL_DTYPE.itemsize
    (msz,) = struct.unpack_from("<I", data, off)
    off += 4
    mtl = data[off : off + msz]
    off += msz

    if num_tris < 1000:
        raw = data[off : off + num_tris * TRI_DTYPE.itemsize]
    else:
        (csz,) = struct.unpack_from("<Q", data, off)
        off += 8
        raw = qlz_decompress(
            data[off : off + csz], num_tris * TRI_DTYPE.itemsize
        )
    tris = np.frombuffer(raw, TRI_DTYPE, num_tris)

    mesh = MeshData(
        v0=np.ascontiguousarray(tris["v0"][:, :3]),
        v1=np.ascontiguousarray(tris["v1"][:, :3]),
        v2=np.ascontiguousarray(tris["v2"][:, :3]),
        uv0=tris["uv0"].astype(np.float32),  # uv.y already flipped on save
        uv1=tris["uv1"].astype(np.float32),
        uv2=tris["uv2"].astype(np.float32),
        n0=tris["n0"].astype(np.float32),
        n1=tris["n1"].astype(np.float32),
        n2=tris["n2"].astype(np.float32),
        mat_idx=tris["mat"].astype(np.int32),
    )
    materials = [
        ObjMaterial(
            name=_cstr(mtl, int(m["name"])) or f"material_{k}",
            diffuse=_unpack_rgb(int(m["diffuse"])),
            specular=_unpack_rgb(int(m["specular"])),
            shininess=float(np.float16(m["shininess"])),
            roughness=float(np.float16(m["roughness"])),
            diffuse_map=_cstr(mtl, int(m["diffuse_path"])),
            specular_map=_cstr(mtl, int(m["specular_path"])),
        )
        for k, m in enumerate(mats)
    ]
    return ObjMesh(mesh=mesh, materials=materials)


def save_clm(path: str | Path, obj: ObjMesh) -> None:
    """Write a reference-compatible ``.clm`` (AssetManager.cpp:294-321).

    Colors/attributes round to the reference's storage precision; at the
    reference's >= 1000-tri threshold the tri blob is a level-1 QuickLZ
    compressed container (AssetManager.cpp:310-318), stored-form below it.
    """
    mesh = obj.mesh
    num_tris = mesh.count

    # rebuild a minimal mtl-text blob holding names + texture paths
    blob = bytearray(b"\0")  # offset 0 means "absent"
    offsets: list[tuple[int, int, int]] = []
    for m in obj.materials:
        def put(s: str | None) -> int:
            if not s:
                return 0
            at = len(blob)
            blob.extend(s.encode("utf-8") + b"\0")
            return at

        offsets.append((put(m.name), put(m.diffuse_map), put(m.specular_map)))

    mats = np.zeros(len(obj.materials), CLM_MATERIAL_DTYPE)
    for k, m in enumerate(obj.materials):
        c = np.clip(np.asarray(m.diffuse, np.float32), 0.0, 1.0) * 255.0
        s = np.clip(np.asarray(m.specular, np.float32), 0.0, 1.0) * 255.0
        mats[k]["name"] = offsets[k][0]
        mats[k]["diffuse"] = int(c[0]) | int(c[1]) << 8 | int(c[2]) << 16
        mats[k]["specular"] = int(s[0]) | int(s[1]) << 8 | int(s[2]) << 16
        mats[k]["shininess"] = np.float16(m.shininess)
        mats[k]["roughness"] = np.float16(m.roughness)
        mats[k]["diffuse_path"] = offsets[k][1]
        mats[k]["specular_path"] = offsets[k][2]

    tris = np.zeros(num_tris, TRI_DTYPE)
    centroid = (mesh.v0 + mesh.v1 + mesh.v2) * np.float32(1 / 3)
    for name, v, c in (("v0", mesh.v0, 0), ("v1", mesh.v1, 1), ("v2", mesh.v2, 2)):
        tris[name][:, :3] = v
        tris[name][:, 3] = centroid[:, c]
    for name, a in (
        ("uv0", mesh.uv0), ("uv1", mesh.uv1), ("uv2", mesh.uv2),
        ("n0", mesh.n0), ("n1", mesh.n1), ("n2", mesh.n2),
    ):
        tris[name] = a.astype(np.float16)
    tris["mat"] = mesh.mat_idx.astype(np.int16)

    out = bytearray()
    out += struct.pack("<Iii", CLM_VERSION, num_tris, len(obj.materials))
    out += mats.tobytes()
    out += struct.pack("<I", len(blob))
    out += bytes(blob)
    if num_tris < 1000:
        out += tris.tobytes()
    else:
        packed = qlz_compress(tris.tobytes())
        out += struct.pack("<Q", len(packed))
        out += packed
    Path(path).write_bytes(bytes(out))


def resolve_asset_path(base: Path, rel: str) -> Path | None:
    """Resolve a texture path stored in a .clm/.mtl against the mesh's
    location: paths are project-root relative ("Assets/sponza/X.JPG") and
    Windows case-insensitive, so try each suffix of the stored path against
    the mesh directory and fix case component-wise."""
    parts = [p for p in rel.replace("\\", "/").split("/") if p and p != "."]
    for skip in range(len(parts)):
        cand = _fix_case(base, parts[skip:])
        if cand is not None:
            return cand
    return None


def _fix_case(root: Path, parts: list[str]) -> Path | None:
    cur = root
    for part in parts:
        if not cur.is_dir():
            return None
        hit = next(
            (e for e in cur.iterdir() if e.name.lower() == part.lower()), None
        )
        if hit is None:
            return None
        cur = hit
    return cur if cur.is_file() else None
