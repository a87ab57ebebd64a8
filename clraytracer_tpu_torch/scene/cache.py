"""Versioned binary mesh cache (a copy of the JAX package's
``scene/cache.py``; both packages read each other's ``.clmz`` files).

Replaces the reference's ``.clm`` format — version header + materials +
embedded MTL text + quicklz-compressed Tri blob (AssetManager.cpp:291-361) —
with a zlib-compressed ``.npz`` (``.clmz``) next to the source OBJ. Import
prefers the cache when present and not stale (reference
AssetManager_ImportMesh, AssetManager.cpp:363-380); a version mismatch falls
back to re-import instead of the reference's fatal exit (AssetManager.cpp:342).
"""

from __future__ import annotations

import dataclasses
import json
import logging
from pathlib import Path

import numpy as np

from clraytracer_tpu_torch.scene.obj import ObjMaterial, ObjMesh, load_obj
from clraytracer_tpu_torch.scene.procedural import MeshData

log = logging.getLogger(__name__)

#: Bump when the on-disk layout changes (reference CMeshVersion,
#: AssetManager.cpp:291).
CACHE_VERSION = 1

CACHE_SUFFIX = ".clmz"


def _materials_to_json(mats: list[ObjMaterial]) -> str:
    return json.dumps(
        [
            {
                "name": m.name,
                "diffuse": [float(x) for x in m.diffuse],
                "specular": [float(x) for x in m.specular],
                "shininess": m.shininess,
                "roughness": m.roughness,
                "diffuse_map": m.diffuse_map,
                "specular_map": m.specular_map,
            }
            for m in mats
        ]
    )


def _materials_from_json(s: str) -> list[ObjMaterial]:
    return [
        ObjMaterial(
            name=d["name"],
            diffuse=np.asarray(d["diffuse"], np.float32),
            specular=np.asarray(d["specular"], np.float32),
            shininess=d["shininess"],
            roughness=d["roughness"],
            diffuse_map=d["diffuse_map"],
            specular_map=d["specular_map"],
        )
        for d in json.loads(s)
    ]


def save_mesh_cache(path: str | Path, obj: ObjMesh) -> Path:
    """Write the compressed cache next to ``path``."""
    cache_path = Path(path).with_suffix(CACHE_SUFFIX)
    m = obj.mesh
    with open(cache_path, "wb") as fh:  # np.savez would append '.npz' to a path
        np.savez_compressed(
            fh,
            version=np.int32(CACHE_VERSION),
            materials=np.frombuffer(
                _materials_to_json(obj.materials).encode(), np.uint8
            ),
            **{
                f.name: getattr(m, f.name) for f in dataclasses.fields(MeshData)
            },
        )
    return cache_path


def load_mesh_cache(cache_path: str | Path) -> ObjMesh | None:
    cache_path = Path(cache_path)
    try:
        with np.load(cache_path) as z:
            if int(z["version"]) != CACHE_VERSION:
                log.warning(
                    "mesh cache %s has version %d != %d; re-importing",
                    cache_path.name, int(z["version"]), CACHE_VERSION,
                )
                return None
            materials = _materials_from_json(bytes(z["materials"]).decode())
            mesh = MeshData(
                **{f.name: z[f.name] for f in dataclasses.fields(MeshData)}
            )
            return ObjMesh(mesh=mesh, materials=materials)
    except Exception as exc:  # corrupt cache → re-import
        log.warning("mesh cache %s unreadable (%s)", cache_path, exc)
        return None


def import_mesh(path: str | Path, use_cache: bool = True) -> ObjMesh:
    """Import an OBJ, preferring a fresh binary cache when available.

    Also accepts the reference's ``.clm`` caches directly, and falls back to
    a sibling ``.clm`` when the OBJ itself is absent — the reference ships
    its big scenes (sponza/sibenik/nanosuit) as ``.clm`` only
    (AssetManager_ImportMesh, AssetManager.cpp:363-380)."""
    from clraytracer_tpu_torch.scene.clm import load_clm

    path = Path(path)
    if path.suffix.lower() == ".clm":
        return load_clm(path)
    clm_path = path.with_suffix(".clm")
    if not path.exists() and clm_path.exists():
        return load_clm(clm_path)
    cache_path = path.with_suffix(CACHE_SUFFIX)
    if use_cache and cache_path.exists():
        if not path.exists() or cache_path.stat().st_mtime >= path.stat().st_mtime:
            cached = load_mesh_cache(cache_path)
            if cached is not None:
                return cached
    obj = load_obj(path)
    if use_cache:
        try:
            save_mesh_cache(path, obj)
        except OSError as exc:  # read-only asset dirs are fine
            log.warning("could not write mesh cache: %s", exc)
    return obj
