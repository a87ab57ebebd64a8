"""Build and bind the hand-written CUDA kernels (csrc/*.cu).

Each ``.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface, loaded with ``ctypes``; no PyTorch header
is included, so a build takes seconds. All sources are compiled in
parallel, one ``nvcc`` process each, at first use, into the package's
``_build`` directory (listed in ``.gitignore``), keyed by a hash of the
sources and flags. A failed build raises: nothing falls back.

Flags: ``--fmad=false`` keeps every ``a * b + c`` as two rounded
operations, as the JAX reference and the plain torch versions compute
them; no ``--use_fast_math`` (IEEE division and square root).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
SOURCES = ("trace.cu", "render.cu", "gather.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
#: ptxas register/spill report of the last build, per source
build_log: dict[str, str] = {}


class SceneTablesC(ctypes.Structure):
    """csrc/traverse.cuh ``SceneTables``."""

    _fields_ = [
        ("inst", ctypes.c_void_p),
        ("ranges", ctypes.c_void_p),
        ("hyper_box", ctypes.c_void_p),
        ("super_box", ctypes.c_void_p),
        ("cluster_box", ctypes.c_void_p),
        ("planes", ctypes.c_void_p),
        ("attrs", ctypes.c_void_p),
        ("n_inst", ctypes.c_int),
    ]


class RenderParamsC(ctypes.Structure):
    """csrc/render.cu ``RenderParams``."""

    _fields_ = [
        ("cam", ctypes.c_float * 36),
        ("sun_sin", ctypes.c_float),
        ("sun_cos", ctypes.c_float),
        ("atm", ctypes.c_void_p),
        ("mat_rows", ctypes.c_void_p),
        ("tex", ctypes.c_void_p),
        ("n_mat", ctypes.c_int),
        ("n_tex", ctypes.c_int),
        ("trows", ctypes.c_int),
        ("tiles_x", ctypes.c_int),
        ("width", ctypes.c_int),
        ("height", ctypes.c_int),
        ("n_rays", ctypes.c_int),
        ("bounces", ctypes.c_int),
        ("atlas_mode", ctypes.c_int),
        ("shadows", ctypes.c_int),
        ("gi", ctypes.c_int),
        ("gi_base", ctypes.c_uint),
    ]


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels build only with nvcc")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def build_all() -> dict[str, ctypes.CDLL]:
    """Compile every source (in parallel, where not yet built) and load the
    libraries. Returns {source name: library}."""
    with _lock:
        if len(_libs) == len(SOURCES):
            return _libs
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tag = _digest()
        outs = {src: BUILD_DIR / f"{Path(src).stem}_{tag}.so" for src in SOURCES}
        procs = {}
        for src, out in outs.items():
            if out.exists():
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            procs[src] = (
                subprocess.Popen(
                    [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                ),
                tmp,
            )
        errors = []
        for src, (proc, tmp) in procs.items():
            log, _ = proc.communicate()
            build_log[src] = log
            if proc.returncode != 0:
                errors.append(f"{src}:\n{log}")
            else:
                os.replace(tmp, outs[src])
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
        for src, out in outs.items():
            _libs[src] = ctypes.CDLL(str(out))
        _bind(_libs)
        return _libs


def _bind(libs: dict[str, ctypes.CDLL]) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = libs["trace.cu"].clrt_trace
    fn.restype = ci
    fn.argtypes = [ctypes.POINTER(SceneTablesC), vp, vp, ci, vp, vp, vp]
    fn = libs["render.cu"].clrt_render
    fn.restype = ci
    fn.argtypes = [
        ctypes.POINTER(SceneTablesC), ctypes.POINTER(RenderParamsC), vp, vp, vp, vp,
    ]
    fn = libs["gather.cu"].clrt_gather_rows
    fn.restype = ci
    fn.argtypes = [vp, ci, ci, vp, ci, vp, vp]
    fn = libs["gather.cu"].clrt_scatter_rows
    fn.restype = ci
    fn.argtypes = [vp, vp, ci, ci, ci, vp, vp]


def check(code: int, what: str) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` from a C entry point."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {code}")


def ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
