"""Full-scene checkpoint: save/restore the complete renderable state in the
JAX package's ``.clsnap.npz`` format (its ``scene/checkpoint.py``).

One compressed ``.npz``: every tensor leaf of the ``Scene`` under an
``a:<dotted path>`` key (``a:scene.tris.v0``, ...), and a ``__meta__``
JSON blob holding the format version, the static fields as tagged JSON
(nested tuples, ``ProceduralTexture`` descriptors, None) and JSON-able
``extras``. Both packages' ``Scene`` classes have the same class and field
names, so a snapshot written by either loads in the other. Restoring
needs no re-import, BVH build or clustering.

The JAX package's HBM-streaming copy of the cluster tables
(``clusters.geo_stream``) is read and dropped: the CUDA kernels read the
tables themselves. This package never writes it, so the JAX loader sees
None there.
"""

from __future__ import annotations

import dataclasses
import io
import json
import logging
from pathlib import Path
from typing import Any

import numpy as np
import torch

from clraytracer_tpu_torch.device import resolve_device
from clraytracer_tpu_torch.scene.procedural_tex import ProceduralTexture
from clraytracer_tpu_torch.scene.types import (
    BVH,
    Clusters,
    Instances,
    Materials,
    PackedTables,
    Scene,
    TextureAtlas,
    Triangles,
)

log = logging.getLogger(__name__)

#: Bump on layout changes; a mismatch raises: a checkpoint is authoritative
#: state, not a cache that can fall back to re-import.
CHECKPOINT_VERSION = 2  # v2: Materials.transmission (refraction channel)

SNAPSHOT_SUFFIX = ".clsnap.npz"

#: leaves of the JAX package's TPU layouts that this package drops on load
_DROPPED = ("scene.clusters.geo_stream",)

_CLASSES: dict[str, type] = {
    c.__name__: c
    for c in (
        Scene,
        Triangles,
        BVH,
        Materials,
        TextureAtlas,
        Instances,
        Clusters,
        PackedTables,
    )
}


def _enc_static(v: Any) -> Any:
    """Tagged JSON encoding of static field values."""
    if isinstance(v, ProceduralTexture):
        return {"__ptex__": _enc_static_dict(dataclasses.asdict(v))}
    if isinstance(v, tuple):
        return {"__tuple__": [_enc_static(x) for x in v]}
    if isinstance(v, np.integer):
        return int(v)
    if isinstance(v, np.floating):
        return float(v)
    if v is None or isinstance(v, (int, float, str, bool)):
        return v
    raise TypeError(f"unserializable static value: {type(v)!r}")


def _enc_static_dict(d: dict) -> dict:
    return {k: _enc_static(tuple(v) if isinstance(v, list) else v)
            for k, v in d.items()}


def _dec_static(v: Any) -> Any:
    if isinstance(v, dict):
        if "__ptex__" in v:
            kw = {k: _dec_static(x) for k, x in v["__ptex__"].items()}
            return ProceduralTexture(**kw)
        if "__tuple__" in v:
            return tuple(_dec_static(x) for x in v["__tuple__"])
    if isinstance(v, list):
        return tuple(_dec_static(x) for x in v)
    return v


def _flatten(obj: Any, prefix: str, arrays: dict, statics: dict) -> None:
    if obj is None:
        statics[prefix] = {"__none__": True}
        return
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        statics[prefix] = {"__class__": type(obj).__name__}
        for f in dataclasses.fields(obj):
            _flatten(getattr(obj, f.name), f"{prefix}.{f.name}", arrays, statics)
        return
    if isinstance(obj, torch.Tensor):
        arrays[prefix] = obj.detach().cpu().numpy()
        return
    if isinstance(obj, np.ndarray):
        arrays[prefix] = obj
        return
    statics[prefix] = {"__static__": _enc_static(obj)}


def _rebuild(prefix: str, arrays: dict, statics: dict) -> Any:
    if prefix in _DROPPED:
        return None
    if prefix in arrays:
        return torch.from_numpy(np.array(arrays[prefix], copy=True))
    node = statics[prefix]
    if "__none__" in node:
        return None
    if "__static__" in node:
        return _dec_static(node["__static__"])
    cls = _CLASSES[node["__class__"]]
    kwargs = {}
    missing_required = []
    for f in dataclasses.fields(cls):
        key = f"{prefix}.{f.name}"
        if key not in arrays and key not in statics:
            # a field newer than this checkpoint takes its default; one
            # without a default fails loudly
            if (
                f.default is dataclasses.MISSING
                and f.default_factory is dataclasses.MISSING
            ):
                missing_required.append(f.name)
            continue
        kwargs[f.name] = _rebuild(key, arrays, statics)
    if missing_required:
        raise ValueError(
            f"checkpoint is missing required field(s) {missing_required} of "
            f"{cls.__name__} (saved by an older version; re-export the scene)"
        )
    return cls(**kwargs)


def save_scene(
    scene: Scene, path: str | Path, extras: dict[str, Any] | None = None
) -> Path:
    """Write the full scene (and JSON-able ``extras``) to ``path``."""
    path = Path(path)
    arrays: dict[str, np.ndarray] = {}
    statics: dict[str, Any] = {}
    _flatten(scene, "scene", arrays, statics)
    meta = {"version": CHECKPOINT_VERSION, "statics": statics, "extras": extras or {}}
    buf = io.BytesIO()
    np.savez_compressed(
        buf,
        __meta__=np.frombuffer(json.dumps(meta).encode("utf-8"), dtype=np.uint8),
        **{f"a:{k}": v for k, v in arrays.items()},
    )
    path.write_bytes(buf.getvalue())
    log.info("saved scene checkpoint %s (%d arrays, %d KiB)",
             path, len(arrays), len(buf.getvalue()) // 1024)
    return path


def load_scene(
    path: str | Path, device: str | torch.device | None = None
) -> tuple[Scene, dict[str, Any]]:
    """Restore ``(scene, extras)`` from a ``save_scene`` checkpoint of
    either package, the scene on ``device`` (None = the CUDA card)."""
    dev = resolve_device(device)
    path = Path(path)
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode("utf-8"))
        if meta["version"] != CHECKPOINT_VERSION:
            raise ValueError(
                f"checkpoint version {meta['version']} != {CHECKPOINT_VERSION} ({path})"
            )
        arrays = {k[2:]: z[k] for k in z.files if k.startswith("a:")}
    scene = _rebuild("scene", arrays, meta["statics"])
    return scene.to(dev), meta["extras"]
