"""Times K2.2's instantiations (clraytracer_tpu_torch/csrc/render.cu) at
1920x1080 (``two`` at 1249x720) and 2 bounces, for the tree it is run
from, and prints render.cu's ptxas report.

    cd <root of a tree> && python3 <path>/tools/torch_k22_variant_times.py \
        [--cases a,k0,k,...]

The package and ``chip_smoke.py`` are imported from the current directory,
so one copy of this script times any tree that has them (a parent unpacked
by ``git archive`` into a gitignored directory, for example): run it from
each tree in turns, in one call on one card.

One JSON line per case: the median and range of 20 launches after 3
warm-ups, each timed by a CUDA-event pair around the call (the host's time
to issue it included), the kernel's time per launch as torch.profiler
records it (``profile_ms``: 10 launches, ``chip_smoke.device_profile``'s
reading),
and the kernel against its plain version on a 128x64 frame of the same
camera. Cases: the default frame on ``sphere`` (a), on ``two`` at
1249x720 (b) and on the 1,002,000-triangle sphere (c), the spheres also
with shadows (a_sh, c_sh) and with shadows under a sun behind the sphere
(a_back, c_back: most bounce-0 hits in shadow); atlas mode 1 (h); GI (j);
the ground scene without shadows (k0), with shadows (k) and with shadows
and GI (k_gi). Needs a CUDA card.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

TRIS_LARGE = 1_000_000
BACKLIT_SUN = 0.0  # chip_smoke.BACKLIT_SUN, for trees that predate it
# (tag, scene of chip_smoke.option_scene, --tris, width, height, sun angle
# or None, options)
CASES = (
    ("a", "sphere", 4096, 1920, 1080, None, {}),
    ("a_sh", "sphere", 4096, 1920, 1080, None, {"shadows": True}),
    ("a_back", "sphere", 4096, 1920, 1080, BACKLIT_SUN, {"shadows": True}),
    ("b", "two", 4096, 1249, 720, None, {}),
    ("c", "sphere", TRIS_LARGE, 1920, 1080, None, {}),
    ("c_sh", "sphere", TRIS_LARGE, 1920, 1080, None, {"shadows": True}),
    ("c_back", "sphere", TRIS_LARGE, 1920, 1080, BACKLIT_SUN, {"shadows": True}),
    ("h", "atlas", 4096, 1920, 1080, None, {}),
    ("j", "sphere", 4096, 1920, 1080, None, {"gi_seed": 0}),
    ("k0", "ground", 4096, 1920, 1080, None, {}),
    ("k", "ground", 4096, 1920, 1080, None, {"shadows": True}),
    ("k_gi", "ground", 4096, 1920, 1080, None, {"shadows": True, "gi_seed": 0}),
)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cases", default=None, help="comma-separated tags (default: all)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_k22_variant_times: CUDA is not available", file=sys.stderr)
        return 2
    from clraytracer_tpu_torch.ops import render_fused as rf
    from clraytracer_tpu_torch.runtime import kernels

    kernels.build_all()
    print(json.dumps({"tree": os.getcwd(),
                      "ptxas": cs.ptxas_summary(kernels.build_log.get("render.cu", ""))}))
    dev = torch.device("cuda", 0)
    want = None if args.cases is None else set(args.cases.split(","))
    scenes = {}
    for tag, spec, tris, w, h, sun, kw in CASES:
        if want is not None and tag not in want:
            continue
        if (spec, tris) not in scenes:
            scenes[(spec, tris)] = cs.option_scene(spec, tris, device=dev)
        scene = scenes[(spec, tris)]
        frames = {}
        for size in ((w, h), (128, 64)):
            frame = cs.option_frame(spec, *size)
            if sun is not None:
                frame = frame._replace(sun_angle=torch.tensor(sun, dtype=torch.float32))
            frames[size] = cs.option_args(scene, frame, *size)
        opts = dict(atlas_mode=rf.atlas_mode_of(scene), **kw)
        fargs = frames[(w, h)]
        launch = lambda: rf.render_cuda(*fargs, **opts)
        ms, times = cs.event_ms(launch, 20, 3)
        prof_ms = cs.device_profile(launch, 10, 1.0)["device_busy_ms_per_call"]
        sargs = frames[(128, 64)]
        chk = cs.compare_options(rf.render_cuda(*sargs, **opts),
                                 rf.render_fused_plain(*sargs, dev, **opts),
                                 opts["atlas_mode"], "gi_seed" in kw)
        print(json.dumps({"cell": tag, "variant": rf.variant(opts["atlas_mode"],
                                                             kw.get("shadows", False),
                                                             "gi_seed" in kw),
                          "triangles": int(scene.tris.count), "width": w, "height": h,
                          "profile_ms": prof_ms, "ms": ms, "min": times[0],
                          "max": times[-1], "ok": chk["ok"],
                          "differ": chk["rays_differing"],
                          "max_abs_err": chk["max_abs_err_all"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
