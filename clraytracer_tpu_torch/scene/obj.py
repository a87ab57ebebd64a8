"""OBJ/MTL importer (a copy of the JAX package's ``scene/obj.py``, so both
packages read a file into the same ``ObjMesh``).

From-scratch importer mirroring the reference's semantics
(AssetManager.cpp:90-289) with a vectorized numpy core instead of a char-level
C parser:

* ``v``/``vt``/``vn`` accumulation; faces as v/vt/vn index triplets
  (AssetManager.cpp:246-281). We additionally support ``v``, ``v/t``, ``v//n``
  forms and >3-vertex faces (fan triangulation) — a superset of the reference.
* uv.y is flipped on import (AssetManager.cpp:271: ``1.0f - v``).
* MTL: ``newmtl``, ``Ns`` (clamped 0..100 then /50 → shininess,
  AssetManager.cpp:152), ``d`` (→ roughness), ``Kd``, ``Ks``, ``map_Kd``,
  ``map_Ks`` (AssetManager.cpp:123-191). Defaults: white diffuse/specular,
  shininess 2.2, roughness 0.6 (AssetManager.cpp:136-137).
* Material lookup is an exact dict (the reference uses a 512-entry hash map
  where collisions are fatal, AssetManager.cpp:144-145).
"""

from __future__ import annotations

import dataclasses
import logging
from pathlib import Path

import numpy as np

from clraytracer_tpu_torch.scene.procedural import MeshData

log = logging.getLogger(__name__)


@dataclasses.dataclass
class ObjMaterial:
    """Parsed MTL material (reference ObjMaterial, AssetManager.hpp:5-14)."""

    name: str
    diffuse: np.ndarray = dataclasses.field(
        default_factory=lambda: np.ones(3, np.float32)
    )
    specular: np.ndarray = dataclasses.field(
        default_factory=lambda: np.ones(3, np.float32)
    )
    shininess: float = 2.2
    roughness: float = 0.6
    diffuse_map: str | None = None
    specular_map: str | None = None


@dataclasses.dataclass
class ObjMesh:
    """Parsed OBJ (reference ObjMesh, AssetManager.hpp:16-23)."""

    mesh: MeshData
    materials: list[ObjMaterial]


def parse_mtl(text: str) -> list[ObjMaterial]:
    materials: list[ObjMaterial] = []
    cur: ObjMaterial | None = None
    for raw in text.splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split(None, 1)
        key = parts[0]
        rest = parts[1].strip() if len(parts) > 1 else ""
        if key == "newmtl":
            cur = ObjMaterial(name=rest)
            materials.append(cur)
        elif cur is None:
            continue
        elif key == "Ns":
            cur.shininess = float(np.clip(float(rest.split()[0]), 0.0, 100.0) / 50.0)
        elif key == "d":
            cur.roughness = float(np.clip(float(rest.split()[0]), 0.0, 1.0))
        elif key == "Kd":
            cur.diffuse = np.array([float(x) for x in rest.split()[:3]], np.float32)
        elif key == "Ks":
            cur.specular = np.array([float(x) for x in rest.split()[:3]], np.float32)
        elif key == "map_Kd":
            cur.diffuse_map = rest.split()[-1]
        elif key == "map_Ks":
            cur.specular_map = rest.split()[-1]
    return materials


def _to_floats(bucket: list[str], width: int) -> np.ndarray:
    if not bucket:
        return np.zeros((0, width), np.float32)
    flat = np.array(" ".join(bucket).split(), dtype=np.float32)
    # tolerate extra components (e.g. 'v x y z w' or 'vt u v w'): reshape by rows
    per_row = flat.size // len(bucket)
    return flat.reshape(len(bucket), per_row)[:, :width]


def _parse_face_corner(token: str) -> tuple[int, int, int]:
    """One face corner 'v', 'v/t', 'v/t/n' or 'v//n' → (v, t, n), 0 = absent."""
    parts = token.split("/")
    v = int(parts[0])
    t = int(parts[1]) if len(parts) > 1 and parts[1] else 0
    n = int(parts[2]) if len(parts) > 2 and parts[2] else 0
    return v, t, n


def _load_obj_native(path: Path, text: str) -> "ObjMesh | None":
    """Native (C++) parse path — same semantics as the Python scan below."""
    from clraytracer_tpu_torch.runtime.fastobj import parse_obj_arrays

    out = parse_obj_arrays(text)
    if out is None:
        return None
    positions, texcoords, normals, pi, ti, ni, stmt = out

    materials: list[ObjMaterial] = []
    mat_index: dict[str, int] = {}
    mtl_path = path.with_suffix(".mtl")
    if mtl_path.exists():
        materials = parse_mtl(mtl_path.read_text(errors="replace"))
        mat_index = {m.name: i for i, m in enumerate(materials)}
    # map usemtl statement order → material ids
    stmt_names = [
        line[7:].strip()
        for line in text.splitlines()
        if line.startswith("usemtl")
    ]
    for line in text.splitlines():
        if line.startswith("mtllib") and not materials:
            extra = path.parent / line[7:].strip()
            if extra.exists():
                materials = parse_mtl(extra.read_text(errors="replace"))
                mat_index = {m.name: i for i, m in enumerate(materials)}
    stmt_to_mat = np.asarray(
        [mat_index.get(nm, 0) for nm in stmt_names] or [0], np.int32
    )
    face_mats = np.where(stmt >= 0, stmt_to_mat[np.clip(stmt, 0, len(stmt_to_mat) - 1)], 0)

    if len(texcoords) == 0:
        texcoords = np.zeros((1, 2), np.float32)
    ti = np.where(ti < 0, 0, ti)
    if len(normals) == 0:
        p0, p1, p2 = (positions[pi[:, k]] for k in range(3))
        fn = np.cross(p1 - p0, p2 - p0)
        fn /= np.maximum(np.linalg.norm(fn, axis=-1, keepdims=True), 1e-20)
        normals = fn.astype(np.float32)
        ni = np.repeat(np.arange(len(fn), dtype=np.int32)[:, None], 3, axis=1)
    ni = np.where(ni < 0, 0, ni)

    uv = texcoords.copy()
    uv[:, 1] = 1.0 - uv[:, 1]

    mesh = MeshData(
        v0=positions[pi[:, 0]],
        v1=positions[pi[:, 1]],
        v2=positions[pi[:, 2]],
        uv0=uv[ti[:, 0]],
        uv1=uv[ti[:, 1]],
        uv2=uv[ti[:, 2]],
        n0=normals[ni[:, 0]],
        n1=normals[ni[:, 1]],
        n2=normals[ni[:, 2]],
        mat_idx=face_mats.astype(np.int32),
    )
    if not materials:
        materials = [ObjMaterial(name="default")]
    return ObjMesh(mesh=mesh, materials=materials)


def load_obj(path: str | Path, prefer_native: bool = True) -> ObjMesh:
    """Parse an OBJ file (+ companion .mtl) into a MeshData + material list.

    Triangle order and attribute quantization mirror the reference importer so
    downstream BVH builds see the same input ordering. Uses the C++ runtime
    parser when available (the reference's char-level importer is native C++,
    AssetManager.cpp:13-35); falls back to the vectorized Python scan.
    """
    path = Path(path)
    text = path.read_text(errors="replace")

    if prefer_native:
        native = _load_obj_native(path, text)
        if native is not None:
            log.info(
                "imported %s (native): %d triangles, %d materials",
                path.name, native.mesh.count, len(native.materials),
            )
            return native

    v_lines: list[str] = []
    vt_lines: list[str] = []
    vn_lines: list[str] = []
    face_corners: list[tuple[int, int, int]] = []
    face_mats: list[int] = []
    mtl_names: list[str] = []

    materials: list[ObjMaterial] = []
    mat_index: dict[str, int] = {}

    # .mtl is found by extension swap like the reference
    # (AssetManager.cpp:107-112); mtllib statements are honoured too.
    mtl_path = path.with_suffix(".mtl")
    if mtl_path.exists():
        materials = parse_mtl(mtl_path.read_text(errors="replace"))
        mat_index = {m.name: i for i, m in enumerate(materials)}

    current_mat = 0
    for raw in text.splitlines():
        if not raw:
            continue
        c0 = raw[0]
        if c0 == "v":
            if raw.startswith("v "):
                v_lines.append(raw[2:])
            elif raw.startswith("vt "):
                vt_lines.append(raw[3:])
            elif raw.startswith("vn "):
                vn_lines.append(raw[3:])
        elif c0 == "f":
            tokens = raw[2:].split()
            corners = [_parse_face_corner(t) for t in tokens]
            # fan-triangulate n-gons (superset of the reference's tri-only path)
            for k in range(1, len(corners) - 1):
                face_corners.extend((corners[0], corners[k], corners[k + 1]))
                face_mats.append(current_mat)
        elif c0 == "u" and raw.startswith("usemtl"):
            name = raw[7:].strip()
            if name in mat_index:
                current_mat = mat_index[name]
            else:
                log.warning("usemtl %r not found in mtl", name)
                current_mat = 0
        elif c0 == "m" and raw.startswith("mtllib"):
            mtl_names.append(raw[7:].strip())
            extra = path.parent / mtl_names[-1]
            if not materials and extra.exists():
                materials = parse_mtl(extra.read_text(errors="replace"))
                mat_index = {m.name: i for i, m in enumerate(materials)}

    positions = _to_floats(v_lines, 3)
    texcoords = _to_floats(vt_lines, 2)
    normals = _to_floats(vn_lines, 3)

    idx = np.asarray(face_corners, np.int64).reshape(-1, 3, 3)  # [T, corner, vtn]

    def resolve(indices: np.ndarray, count: int) -> np.ndarray:
        """OBJ 1-based; negative = relative from end; 0 = absent → slot 0."""
        out = np.where(indices > 0, indices - 1, indices + count)
        return np.where(indices == 0, 0, out)

    pi = resolve(idx[..., 0], len(positions))
    ti = resolve(idx[..., 1], len(texcoords))
    ni = resolve(idx[..., 2], len(normals))

    if len(texcoords) == 0:
        texcoords = np.zeros((1, 2), np.float32)
        ti = np.zeros_like(ti)
    if len(normals) == 0:
        # face normals as fallback (reference requires vn; superset)
        p0, p1, p2 = (positions[pi[:, k]] for k in range(3))
        fn = np.cross(p1 - p0, p2 - p0)
        fn /= np.maximum(np.linalg.norm(fn, axis=-1, keepdims=True), 1e-20)
        normals = fn.astype(np.float32)
        ni = np.repeat(np.arange(len(fn))[:, None], 3, axis=1)

    uv = texcoords.copy()
    uv[:, 1] = 1.0 - uv[:, 1]  # V flip on import (AssetManager.cpp:271)

    mesh = MeshData(
        v0=positions[pi[:, 0]],
        v1=positions[pi[:, 1]],
        v2=positions[pi[:, 2]],
        uv0=uv[ti[:, 0]],
        uv1=uv[ti[:, 1]],
        uv2=uv[ti[:, 2]],
        n0=normals[ni[:, 0]],
        n1=normals[ni[:, 1]],
        n2=normals[ni[:, 2]],
        mat_idx=np.asarray(face_mats, np.int32),
    )
    if not materials:
        materials = [ObjMaterial(name="default")]
    log.info("imported %s: %d triangles, %d materials",
                      path.name, mesh.count, len(materials))
    return ObjMesh(mesh=mesh, materials=materials)
