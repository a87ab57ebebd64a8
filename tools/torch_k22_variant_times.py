"""Times K2.2's instantiations (clraytracer_tpu_torch/csrc/render.cu) at
1920x1080 (``two`` at 1249x720) and 2 bounces, for the tree it is run
from, and prints render.cu's ptxas report.

    cd <root of a tree> && python3 <path>/tools/torch_k22_variant_times.py \
        [--cases a,k0,k,t,...] [--walk-stats]

The package and ``chip_smoke.py`` are imported from the current directory,
so one copy of this script times any tree that has them (a parent unpacked
by ``git archive`` into a gitignored directory, for example): run it from
each tree in turns, in one call on one card.

One JSON line per case: the median and range of 20 launches after 3
warm-ups, each timed by a CUDA-event pair around the call (the host's time
to issue it included), the kernel's time per launch as torch.profiler
records it (``profile_ms``: 10 launches, ``chip_smoke.device_profile``'s
reading), the card's time by ``chip_smoke.device_ms`` (``device_ms``),
and the kernel against its plain version on a 128x64 frame of the same
camera, with the launch's counters and K2.1's device ms on the case's
camera rays and on their bounce-0 shadow rays (the hits live, as the
two-phase path's shadow launch). Cases: the default frame on ``sphere``
(a), on ``two`` at 1249x720 (b) and on the 1,002,000-triangle sphere
(c), the spheres also
with shadows (a_sh, c_sh) and with shadows under a sun behind the sphere
(a_back, c_back: most bounce-0 hits in shadow); atlas mode 1 (h), mode 2
(i); GI (j); ray mode on the sphere's camera rays (r);
the ground scene without shadows (k0), with shadows (k) and with shadows
and GI (k_gi); the museum-class imported scene (t: ``chip_smoke``'s
``write_museum`` written into a temporary directory and built by
``build_museum``, atlas mode 1, its camera inside the atrium). The split
cases of ``chip_smoke.py``'s cell (s) (sa, sc, sk0, sk, sfield: (a),
(c), (k0), (k) and ``field``) time ``render_fused_camera`` with
``split_rebin`` off and on, in turns (unsplit, split, split, unsplit), by
call ms and device ms, and the split's parts by device ms: the carry-out
launch, the glue between the launches (the per-ray key sort,
``sort_keys``) and the carry-in launch, with the glue's launches by
torch.profiler.

``--walk-stats`` adds a ``walk`` line per case: K2.2's frame and its
bounce 0 alone (a launch of 1 bounce), each by call ms (``event_ms``) and
device ms (``device_ms``); the six counters of each bounce (bounce 1 is
the frame's less bounce 0's) with the figures of ``bounce_split`` (from
the ``chip_smoke.py`` beside this script); the share of the warps' node
steps that took a children-outer test (the hierarchy's child test or the
instance level's world test), counted by a second build of the
tree's csrc/ under a compile-time switch of this script
(``stats_sources``: the ray-transform counter moved into the
children-outer branch; the shipped kernels do not count it); and K2.1 on
the case's camera rays with the same figures.
Needs a CUDA card.
"""

import argparse
import ctypes
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

TRIS_LARGE = 1_000_000
BACKLIT_SUN = 0.0  # chip_smoke.BACKLIT_SUN, for trees that predate it
# (tag, scene of chip_smoke.option_scene or "museum", --tris, width,
# height, sun angle or None, options; "rays": ray mode on the camera's
# tiled rays, as cell (r) of chip_smoke.py)
CASES = (
    ("a", "sphere", 4096, 1920, 1080, None, {}),
    ("a_sh", "sphere", 4096, 1920, 1080, None, {"shadows": True}),
    ("a_back", "sphere", 4096, 1920, 1080, BACKLIT_SUN, {"shadows": True}),
    ("b", "two", 4096, 1249, 720, None, {}),
    ("c", "sphere", TRIS_LARGE, 1920, 1080, None, {}),
    ("c_sh", "sphere", TRIS_LARGE, 1920, 1080, None, {"shadows": True}),
    ("c_back", "sphere", TRIS_LARGE, 1920, 1080, BACKLIT_SUN, {"shadows": True}),
    ("h", "atlas", 4096, 1920, 1080, None, {}),
    ("i", "atlas65", 4096, 1920, 1080, None, {}),
    ("j", "sphere", 4096, 1920, 1080, None, {"gi_seed": 0}),
    ("k0", "ground", 4096, 1920, 1080, None, {}),
    ("k", "ground", 4096, 1920, 1080, None, {"shadows": True}),
    ("k_gi", "ground", 4096, 1920, 1080, None, {"shadows": True, "gi_seed": 0}),
    ("t", "museum", 0, 1920, 1080, None, {}),
    ("r", "sphere", 4096, 1920, 1080, None, {"rays": True}),
    ("sa", "sphere", 4096, 1920, 1080, None, {"split": True}),
    ("sc", "sphere", TRIS_LARGE, 1920, 1080, None, {"split": True}),
    ("sk0", "ground", 4096, 1920, 1080, None, {"split": True}),
    ("sk", "ground", 4096, 1920, 1080, None, {"split": True, "shadows": True}),
    ("sfield", "field", 4096, 1920, 1080, None, {"split": True}),
)
# the lines of traverse.cuh that open a children-outer test (the hierarchy's
# child test and the instance level's world test), and the ray-transform
# count that the statistics build moves there
CHILDREN_OUTER_MARK = "// children outer"
XFORM_COUNT = "++cnt.xforms;"


def own_chip_smoke():
    """This script's own tree's ``chip_smoke.py`` (its walk figures, which
    a parent tree's may lack), imported by path."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_of_this_tool", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def stats_sources(tree: Path, dst: Path) -> None:
    """The tree's csrc/ copied into ``dst`` with traverse.cuh's
    ray-transform count moved to the first line of each children-outer test
    (one in trees before the instance level, two since): the third counter
    of a launch from this copy counts its children-outer node steps."""
    src = tree / "clraytracer_tpu_torch" / "csrc"
    for f in src.iterdir():
        (dst / f.name).write_bytes(f.read_bytes())
    text = (src / "traverse.cuh").read_text()
    lines = text.replace(XFORM_COUNT, ";").splitlines(keepends=True)
    at = [k for k, ln in enumerate(lines) if CHILDREN_OUTER_MARK in ln]
    if text.count(XFORM_COUNT) != 1 or not 1 <= len(at) <= 2:
        raise SystemExit("walk stats: traverse.cuh has no children-outer branch")
    for k in reversed(at):
        lines.insert(k + 1, "      if (lane == 0) " + XFORM_COUNT + "\n")
    (dst / "traverse.cuh").write_text("".join(lines))


def start_stats_build(tree: Path, dst: Path) -> dict:
    """nvcc of trace.cu and render.cu from ``stats_sources``, one process
    each, started."""
    from clraytracer_tpu_torch.runtime import kernels

    stats_sources(tree, dst)
    return {src: subprocess.Popen(
        [kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(dst / (src + ".so")), str(dst / src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src in ("trace.cu", "render.cu")}


def finish_stats_build(procs: dict, dst: Path) -> dict:
    """The statistics libraries, bound as ``kernels._bind`` binds the
    built ones (the tree's other libraries, built as shipped, beside
    them)."""
    from clraytracer_tpu_torch.runtime import kernels

    libs = {}
    for src, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"walk stats: nvcc {src} failed:\n{log}")
        libs[src] = ctypes.CDLL(str(dst / (src + ".so")))
    for src, lib in kernels.build_all().items():
        libs.setdefault(src, lib)
    kernels._bind(libs)
    return libs


def counted(fn, dev, stats_libs=None) -> list:
    """The six counters of one call ``fn(counters)``, with the statistics
    libraries standing in for the built ones where given."""
    from clraytracer_tpu_torch.runtime import kernels

    real = dict(kernels._libs)
    if stats_libs is not None:
        kernels._libs.update(stats_libs)
    try:
        c = torch.zeros(6, dtype=torch.int64, device=dev)
        fn(c)
        return c.cpu().tolist()
    finally:
        kernels._libs.update(real)


def walk_line(tag, frame, fargs, opts, w, h, dev, stats_libs) -> dict:
    """The ``--walk-stats`` line of one case (see the module's docstring)."""
    from clraytracer_tpu_torch.ops import render_fused as rf
    from clraytracer_tpu_torch.ops import trace as tr

    one = fargs[:7] + (1,)
    k22 = lambda a: (lambda c=None: rf.render_cuda(*a, c, **opts))
    line = {"cell": tag, "walk": "K2.2"}
    for name, a in (("frame", fargs), ("bounce0", one)):
        line[f"{name}_ms"] = cs.event_ms(k22(a), 20, 3)[0]
        line[f"{name}_device_ms"] = cs.device_ms(k22(a))
    c2, c1 = counted(k22(fargs), dev), counted(k22(one), dev)
    o2, o1 = counted(k22(fargs), dev, stats_libs), counted(k22(one), dev, stats_libs)
    here = own_chip_smoke()
    line.update(here.bounce_split(c2, c1, fargs[6] * 128))
    for name, co, steps in (("bounce0", o1[2], c1[4]), ("bounce1", o2[2] - o1[2], c2[4] - c1[4])):
        line[name]["children_outer_steps"] = co
        line[name]["children_outer_share"] = co / steps if steps else None
    line["bounce1_share_device_ms"] = 1.0 - line["bounce0_device_ms"] / line["frame_device_ms"]
    rays, _ = cs.camera_rays(w, h, dev, frame)
    k21 = lambda c=None: tr.trace_cuda(fargs[0], rays, None, c)
    c, o = counted(k21, dev), counted(k21, dev, stats_libs)
    line["k21_camera_rays"] = {
        "ms": cs.event_ms(k21, 20, 3)[0], "device_ms": cs.device_ms(k21),
        "counts": dict(zip(tr.COUNTER_NAMES, c)), **here.walk_figures(c, rays.shape[1]),
        "children_outer_share": o[2] / c[4] if c[4] else None}
    return line


def split_line(tag, scene, frame, w, h, shadows) -> dict:
    """A split case's line (see the module's docstring)."""
    from clraytracer_tpu_torch.ops import render_fused as rf

    frame_fn = lambda split: (lambda: rf.render_fused_camera(
        scene, frame, w, h, 2, enable_shadows=shadows, split_rebin=split)[0])
    line = {"cell": tag, "variant": "split", "triangles": int(scene.tris.count),
            "width": w, "height": h, "shadows": shadows}
    for k, name in enumerate(("unsplit", "split", "split", "unsplit")):
        fn = frame_fn(name == "split")
        line[f"{k}_{name}_ms"] = cs.event_ms(fn, 20, 3)[0]
        line[f"{k}_{name}_device_ms"] = cs.device_ms(fn)
    args = cs.option_args(scene, frame, w, h, bounces=1)
    carry_out = lambda: rf.render_cuda(*args, carry_out=True, shadows=shadows)
    first = carry_out()
    keys, order = rf.sort_keys(first)
    buf = first.clone()
    glue = lambda: rf.sort_keys(first)
    carry_in = lambda: rf.render_cuda(*args, carry=buf, keys=keys, order=order, start_bounce=1)
    for name, fn in (("carry_out", carry_out), ("glue", glue), ("carry_in", carry_in)):
        line[f"{name}_device_ms"] = cs.device_ms(fn)
    prof = cs.device_profile(glue, 5, 1.0)
    line["glue_profile_ms"] = prof["device_busy_ms_per_call"]
    line["glue_launches"] = prof["device_launches_per_call"]
    line["glue_kernels"] = prof["kernels"]
    return line


def museum_scene(root: Path, dev):
    """(t)'s scene as ``chip_smoke.phase_imported`` builds it: the files
    (``write_museum``), the figure's ``.clm`` and the gallery's ``.clmz``
    cache written, then ``build_museum``."""
    from clraytracer_tpu_torch.scene import cache, clm, obj

    root.mkdir()
    paths = cs.write_museum(root)
    clm.save_clm(paths["figure"].with_suffix(".clm"), obj.load_obj(paths["figure"]))
    cache.import_mesh(paths["gallery"])
    return cs.build_museum(paths, dev, cs.StepTimer())[0]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cases", default=None, help="comma-separated tags (default: all)")
    ap.add_argument("--walk-stats", action="store_true",
                    help="a walk line per case (see the module's docstring)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_k22_variant_times: CUDA is not available", file=sys.stderr)
        return 2
    with tempfile.TemporaryDirectory() as tmp:
        return run(args, Path(tmp))


def run(args, tmp: Path) -> int:
    from clraytracer_tpu_torch.ops import render_fused as rf
    from clraytracer_tpu_torch.ops import trace as tr
    from clraytracer_tpu_torch.runtime import kernels

    stats = start_stats_build(Path(os.getcwd()), tmp) if args.walk_stats else None
    kernels.build_all()
    print(json.dumps({"tree": os.getcwd(),
                      "ptxas": cs.ptxas_summary(kernels.build_log.get("render.cu", ""))}))
    stats_libs = finish_stats_build(stats, tmp) if stats is not None else None
    dev = torch.device("cuda", 0)
    want = None if args.cases is None else set(args.cases.split(","))
    scenes = {}
    for tag, spec, tris, w, h, sun, kw in CASES:
        if want is not None and tag not in want:
            continue
        if (spec, tris) not in scenes:
            if spec == "museum":
                scenes[(spec, tris)] = museum_scene(tmp / "museum", dev)
            else:
                scenes[(spec, tris)] = cs.option_scene(spec, tris, device=dev)
        scene = scenes[(spec, tris)]
        if kw.get("split"):
            print(json.dumps(split_line(tag, scene, cs.option_frame(spec, w, h), w, h,
                                        kw.get("shadows", False))), flush=True)
            continue
        ray_mode = kw.get("rays", False)
        kw = {k: v for k, v in kw.items() if k != "rays"}
        frames, cams, sopts = {}, {}, {}
        for size in ((w, h), (128, 64)):
            frame = cs.museum_frame(*size) if spec == "museum" else cs.option_frame(spec, *size)
            if sun is not None:
                frame = frame._replace(sun_angle=torch.tensor(sun, dtype=torch.float32))
            cams[size] = frame
            frames[size] = cs.option_args(scene, frame, *size)
            sopts[size] = dict(atlas_mode=rf.atlas_mode_of(scene), **kw)
            if ray_mode:
                sopts[size]["rays"] = cs.camera_rays(*size, dev, frame)[0]
        opts = sopts[(w, h)]
        fargs = frames[(w, h)]
        launch = lambda: rf.render_cuda(*fargs, **opts)
        ms, times = cs.event_ms(launch, 20, 3)
        prof_ms = cs.device_profile(launch, 10, 1.0)["device_busy_ms_per_call"]
        dev_ms = cs.device_ms(launch)
        counts = counted(lambda c: rf.render_cuda(*fargs, c, **opts), dev)
        crays, _ = cs.camera_rays(w, h, dev, cams[(w, h)])
        k21_dev_ms = cs.device_ms(lambda: tr.trace_cuda(fargs[0], crays))
        # K2.1 on the case's bounce-0 shadow rays, the hits live (the
        # two-phase path's shadow launch, cell (o) of chip_smoke.py)
        srays, hit = cs.shadow_rays(fargs[0], crays, tr.trace_cuda(fargs[0], crays),
                                    fargs[2].sun)
        live = hit.float()
        k21_shadow_dev_ms = cs.device_ms(lambda: tr.trace_cuda(fargs[0], srays, live))
        del crays, srays, live
        sargs, so = frames[(128, 64)], sopts[(128, 64)]
        chk = cs.compare_options(rf.render_cuda(*sargs, **so),
                                 rf.render_fused_plain(*sargs, dev, **so),
                                 opts["atlas_mode"], "gi_seed" in kw)
        print(json.dumps({"cell": tag, "variant": rf.variant(opts["atlas_mode"],
                                                             kw.get("shadows", False),
                                                             "gi_seed" in kw, ray_mode),
                          "triangles": int(scene.tris.count), "width": w, "height": h,
                          "profile_ms": prof_ms, "device_ms": dev_ms, "ms": ms,
                          "min": times[0], "max": times[-1],
                          "box_tests_per_pixel": counts[0] / (w * h),
                          "k21_camera_rays_device_ms": k21_dev_ms,
                          "k21_shadow_rays_device_ms": k21_shadow_dev_ms,
                          "counts": dict(zip(tr.COUNTER_NAMES, counts)), "ok": chk["ok"],
                          "differ": chk["rays_differing"],
                          "max_abs_err": chk["max_abs_err_all"]}), flush=True)
        if args.walk_stats:
            print(json.dumps(walk_line(tag, cams[(w, h)], fargs, opts, w, h, dev,
                                       stats_libs)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
