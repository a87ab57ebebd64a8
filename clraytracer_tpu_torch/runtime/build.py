"""On-demand g++ build + ctypes binding of the native BVH builder.

The source (native/bvh_native.cpp) is a copy of the JAX package's, compiled
with the same flags, so both packages build bit-identical BVHs on one
machine. The library goes into the package's ``_build`` directory, keyed by
a hash of the source.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
from pathlib import Path

_NATIVE_DIR = Path(__file__).parent / "native"
_SOURCES = ["bvh_native.cpp"]
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"

_lib: ctypes.CDLL | None = None
_tried = False


def _compile() -> Path | None:
    h = hashlib.sha256()
    for src in _SOURCES:
        h.update((_NATIVE_DIR / src).read_bytes())
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / f"libclrt_bvh_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [
        "g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
        "-pthread", "-o", str(tmp), *(str(_NATIVE_DIR / s) for s in _SOURCES),
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError) as exc:
        logging.getLogger(__name__).warning(
            "native BVH build failed (%s); using the numpy builder", exc
        )
        return None
    os.replace(tmp, out)  # atomic: concurrent builders never see half a file
    return out


def native_lib() -> ctypes.CDLL | None:
    """The compiled native library, or None when unavailable."""
    global _lib, _tried
    if _lib is None and not _tried:
        _tried = True
        so = _compile()
        if so is not None:
            lib = ctypes.CDLL(str(so))
            c_long_p = ctypes.POINTER(ctypes.c_long)
            c_f32_p = ctypes.POINTER(ctypes.c_float)
            c_i32_p = ctypes.POINTER(ctypes.c_int32)
            lib.clrt_build_bvh.restype = ctypes.c_long
            lib.clrt_build_bvh.argtypes = [
                c_f32_p, c_f32_p, c_f32_p, ctypes.c_long,
                c_long_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                c_f32_p, c_f32_p, c_i32_p, c_i32_p, c_i32_p, c_i32_p,
                ctypes.c_long,
            ]
            _lib = lib
    return _lib
