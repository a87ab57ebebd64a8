"""The port's public surface against the JAX package's, on the CPU.

* The names the port gained last behave as the JAX ones: the native
  runtime's ``native_available``, ``as_device_scene``, ``ShardingConfig``,
  ``NONE_MATERIAL``, the mesh axis names, the ``ops`` re-exports, and the
  four planar transforms (atol 1e-6 on seeded inputs).
* ``cli render --profile-dir`` writes a ``*.pt.trace.json``; the two
  profiling tools of the step print their rows.
* Every public top-level name of every JAX module exists in its port
  (read from the source files with ``ast``; neither package is imported
  for it), so do the CLI's subcommands and flags and the root's entry
  files, but for the deliberate exceptions of ``MISSING_ON_PURPOSE``.
"""

import ast
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
JAX_PKG, PORT_PKG = ROOT / "clraytracer_tpu", ROOT / "clraytracer_tpu_torch"

# ---------------------------------------------------------------------------
# the names the port gained last
# ---------------------------------------------------------------------------


def test_native_available_reports_native_lib():
    from clraytracer_tpu_torch import runtime
    from clraytracer_tpu_torch.runtime import build

    assert runtime.native_available is build.native_available
    assert runtime.native_lib is build.native_lib
    assert runtime.native_available() == (runtime.native_lib() is not None)


def test_as_device_scene_moves_every_leaf():
    from clraytracer_tpu_torch.cli import build_scene
    from clraytracer_tpu_torch.scene.types import as_device_scene

    scene = build_scene("two", device="cpu")
    moved = as_device_scene(scene, "cpu")
    assert moved.device.type == "cpu"
    assert torch.equal(moved.tris.v0, scene.tris.v0)
    assert torch.equal(moved.materials.albedo, scene.materials.albedo)


def test_sharding_config_and_constants_equal_jax():
    from clraytracer_tpu.config import ShardingConfig as JShardingConfig
    from clraytracer_tpu.parallel import geometry as jgeo
    from clraytracer_tpu.parallel import sharding as jsh
    from clraytracer_tpu.scene import builder as jbuilder
    from clraytracer_tpu_torch.config import ShardingConfig
    from clraytracer_tpu_torch.parallel import geometry as geo
    from clraytracer_tpu_torch.parallel import sharding as sh
    from clraytracer_tpu_torch.scene import builder

    assert dataclasses.asdict(ShardingConfig()) == dataclasses.asdict(JShardingConfig())
    assert ShardingConfig() == ShardingConfig(data_axis="devices", row_align=8)
    assert builder.NONE_MATERIAL == jbuilder.NONE_MATERIAL == 0
    assert (sh.AXIS, geo.GEO_AXIS, geo.RAY_AXIS) == (jsh.AXIS, jgeo.GEO_AXIS, jgeo.RAY_AXIS)
    assert geo.RAY_AXIS == sh.AXIS == ShardingConfig().data_axis


def test_ops_reexports():
    from clraytracer_tpu_torch import ops
    from clraytracer_tpu_torch.ops import intersect, post, shade

    assert (ops.intersect_aabb, ops.intersect_tris) == (intersect.intersect_aabb,
                                                        intersect.intersect_tris)
    assert (ops.sample_skybox, ops.sample_texture, ops.shade_hits) == (
        shade.sample_skybox, shade.sample_texture, shade.shade_hits)
    assert ops.post_process is post.post_process


@pytest.mark.parametrize("name", ["transform_point", "transform_vector",
                                  "transform_point_batched", "transform_vector_batched"])
def test_planar_transforms_match_jax(name):
    from clraytracer_tpu.ops import planar as jplanar
    from clraytracer_tpu_torch.ops import planar

    rng = np.random.default_rng(11)
    n = 1000
    p = rng.standard_normal((3, n)).astype(np.float32) * 5
    m = rng.standard_normal((n, 4, 4) if name.endswith("batched") else (4, 4))
    m = m.astype(np.float32)
    ref = np.asarray(getattr(jplanar, name)(jnp.asarray(p), jnp.asarray(m)))
    got = getattr(planar, name)(torch.from_numpy(p), torch.from_numpy(m))
    assert got.shape == (3, n) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# render --profile-dir and the profiling tools
# ---------------------------------------------------------------------------


def test_render_profile_dir_writes_trace(tmp_path):
    from clraytracer_tpu_torch import cli

    prof = tmp_path / "prof"
    assert cli.main(["render", "--scene", "two", "--width", "32", "--height", "24",
                     "--device", "cpu", "--profile-dir", str(prof),
                     "-o", str(tmp_path / "two.png")]) == 0
    traces = list(prof.glob("*.pt.trace.json"))
    assert len(traces) == 1 and traces[0].stat().st_size > 0
    assert (tmp_path / "two.png").stat().st_size > 0
    # the program's spans ride in the exported trace
    names = {e.get("name") for e in json.loads(traces[0].read_text())["traceEvents"]}
    assert {"render.prepare", "render.k22", "render.finish", "render.post"} <= names


SIZE = ["--width", "32", "--height", "24", "--device", "cpu"]


def test_profile_step_prints_top_ops(capsys):
    from clraytracer_tpu_torch.tools import profile_step

    assert profile_step.main(SIZE + ["--reps", "2", "--top", "5"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("step 32x24: ") and "CPU run" in lines[0]
    assert len(lines) == 6
    assert all(" ms  x" in line for line in lines[1:])


def test_grads_breakdown_prints_groups(capsys):
    from clraytracer_tpu_torch.tools import grads_breakdown

    assert grads_breakdown.main(SIZE + ["--iters", "1"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert "host clock" in lines[0]
    labels = [line[:40].strip() for line in lines[1:]]
    assert labels == ["fwd only (diff path, no grad)", "grads: ALL leaves", "grads: no tris",
                      "grads: no materials", "grads: no atlas", "grads: no instances"]
    assert all(float(line.split()[-2]) > 0 for line in lines[1:])


# ---------------------------------------------------------------------------
# the name-by-name comparison
# ---------------------------------------------------------------------------

#: JAX modules whose port has another file: the Pallas kernels' modules and
#: the wrappers of their CUDA ports
PORT_FILE = {
    "ops/trace_pallas.py": "ops/trace.py",
    "ops/render_pallas.py": "ops/render_fused.py",
    "ops/gather_pallas.py": "ops/gather_rows.py",
}
#: public names of those modules whose port has another name
PORT_NAME = {
    ("ops/trace_pallas.py", "trace_pallas"): "trace",
    ("ops/gather_pallas.py", "take_rows_mxu"): "TakeRows",
}
_TPU_TILING = ("the Pallas kernel's TPU tiling, VMEM budget or streaming choice: the CUDA "
               "kernel's launch geometry replaces it (ROADMAP: drop the TPU layout workarounds)")
_TPU_GATHER = ("a TPU gather strategy or its threshold: the port computes the function "
               "through K2.3/K2.4")
_SYNC_TIMER = ("it synchronised the whole card after each call and nothing in the port read "
               "it; the port's spans are ScopeTimer's, on the profiler's clock")
#: (JAX file, name) → why the port has no such name; a file with name None
#: has no port at all. The test fails if an entry is not missing any more.
MISSING_ON_PURPOSE = {
    **{("ops/gather.py", n): _TPU_GATHER for n in (
        "onehot_rows", "onehot_rows_exact", "select_rows_diff", "take_rows_sorted_vjp",
        "take_rows_sorted_perm_vjp", "ONEHOT_DIFF_MAX_ROWS", "SELECT_DIFF_MAX_ROWS",
        "SORTED_VJP_MIN_N", "SORTED_VJP_WIDE_MIN_N")},
    ("render.py", "render_frame_jit"): "wraps jax.jit",
    ("render.py", "trace_pallas_live_kw"): ("a keyword adapter for the Pallas tracer; the "
                                            "port's ops.trace.trace takes live itself"),
    ("utils/pytree.py", None): "JAX pytree registration; the port's dataclasses need none",
    ("utils/__init__.py", "pytree_dataclass"): "re-export of utils/pytree.py",
    ("utils/__init__.py", "static_field"): "re-export of utils/pytree.py",
    ("utils/timer.py", "timed"): _SYNC_TIMER,
    ("utils/__init__.py", "timed"): _SYNC_TIMER,
    **{("ops/gather_pallas.py", n): _TPU_TILING for n in (
        "TILE", "CHUNK", "TABLE_MAX_ROWS", "WMAX", "supported")},
    **{("ops/trace_pallas.py", n): _TPU_TILING for n in (
        "TILE", "MAX_ROWS", "STREAM_PIPE", "HYPER_MIN_SUPERS", "HYPER_SORT_MIN_SUPERS",
        "VMEM_TABLE_BUDGET", "align_vma", "out_vma")},
    **{("ops/render_pallas.py", n): _TPU_TILING for n in (
        "FUSED_ROWS", "FUSED_ROWS_STREAM", "FUSED_ROWS_STREAM_DENSE",
        "FUSED_ROWS_STREAM_MAX_CLUSTERS")},
    ("ops/render_pallas.py", "fused_path_preferred"): (
        "a TPU choice of the two-phase path for streamed scenes; the port always takes "
        "the fused kernel where it covers the frame"),
    **{(f"tools/{t}.py", None): why for t, why in (
        ("scatter_bench", "measures XLA's serialized scatter on the TPU"),
        ("gather_mxu_bench", "measures the TPU's one-hot MXU gather"),
        ("tpu_stream_smoke", "measures the TPU's HBM-streamed geometry"),
        ("perf_breakdown", "chained fori_loop timing; CUDA events replace it"))},
}


def _aliases(tree: ast.Module) -> set[str]:
    """Top-level type aliases of JAX array types (``Array = jnp.ndarray``,
    ``Vec3 = Array``): annotations, not API."""
    out = {a.asname or a.name for node in tree.body if isinstance(node, ast.ImportFrom)
           and node.module == "jax" for a in node.names if a.name == "Array"}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            v = node.value
            jax_type = (isinstance(v, ast.Attribute) and v.attr in ("ndarray", "Array")
                        and isinstance(v.value, ast.Name) and v.value.id in ("jnp", "jax"))
            if jax_type or (isinstance(v, ast.Name) and v.id in out):
                out |= {t.id for t in node.targets if isinstance(t, ast.Name)}
    return out


def _defined(path: Path, package: str | None = None, private: bool = False) -> set[str]:
    """Public names (with ``private`` all names) a module defines at top
    level: functions, classes and assignments, and in a package's
    ``__init__.py`` what it re-exports from ``package``. Type aliases of
    JAX array types are left out."""
    tree = ast.parse(path.read_text())
    names: set[str] = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            names.add(node.target.id)
        elif (package and path.name == "__init__.py" and isinstance(node, ast.ImportFrom)
              and (node.module or "").split(".")[0] == package):
            names |= {a.asname or a.name for a in node.names}
    return {n for n in names - _aliases(tree) if private or not n.startswith("_")}


def _bound(path: Path) -> set[str]:
    """Every name a module binds at top level, imports included: what
    ``module.<name>`` finds."""
    tree = ast.parse(path.read_text())
    names = _defined(path, private=True) | _aliases(tree)
    for node in tree.body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names |= {(a.asname or a.name).split(".")[0] for a in node.names}
    return names


def _missing() -> dict:
    """(JAX file, name) of every public JAX name the port lacks; (file,
    None) where the port has no file."""
    out = {}
    for jpath in sorted(JAX_PKG.rglob("*.py")):
        rel = jpath.relative_to(JAX_PKG).as_posix()
        ppath = PORT_PKG / PORT_FILE.get(rel, rel)
        if not ppath.exists():
            out[(rel, None)] = "no port file"
            continue
        have = _bound(ppath)
        for name in _defined(jpath, "clraytracer_tpu"):
            if PORT_NAME.get((rel, name), name) not in have:
                out[(rel, name)] = "missing"
    # the root's entry files, and its tools that run the JAX package: a
    # port file each, and the entry's every function, the private ones too
    roots = {"__graft_entry__.py": "entry.py", "bench.py": "bench.py"}
    roots |= {f"tools/{p.name}": f"tools/{p.name}" for p in (ROOT / "tools").glob("*.py")
              if _imports(p) & {"jax", "clraytracer_tpu"}}
    for rel, port in roots.items():
        if not (PORT_PKG / port).exists():
            out[(rel, None)] = "no port file"
    have = _bound(PORT_PKG / "entry.py")
    for node in ast.parse((ROOT / "__graft_entry__.py").read_text()).body:
        if isinstance(node, ast.FunctionDef) and node.name not in have:
            out[("__graft_entry__.py", node.name)] = "missing"
    return out


def _imports(path: Path) -> set[str]:
    """The top-level packages a file imports, anywhere in it."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            out.add(node.module.split(".")[0])
    return out


def test_every_public_jax_name_has_a_port():
    missing = _missing()
    assert set(missing) == set(MISSING_ON_PURPOSE), {
        "missing without a reason": sorted(set(missing) - set(MISSING_ON_PURPOSE), key=str),
        "listed but present": sorted(set(MISSING_ON_PURPOSE) - set(missing), key=str),
    }
    for key, name in PORT_NAME.items():
        assert name in _bound(PORT_PKG / PORT_FILE[key[0]]), key


def _cli_words(path: Path) -> set[str]:
    """The subcommands (``add_parser``) and option strings (``add_argument``)
    of a CLI module."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr in ("add_parser", "add_argument")):
            out |= {a.value for a in node.args
                    if isinstance(a, ast.Constant) and isinstance(a.value, str)}
    return out


def test_cli_has_every_jax_subcommand_and_flag():
    jax_words = _cli_words(JAX_PKG / "cli.py")
    assert "--profile-dir" in jax_words and "sweep" in jax_words
    assert jax_words <= _cli_words(PORT_PKG / "cli.py"), sorted(
        jax_words - _cli_words(PORT_PKG / "cli.py"))
