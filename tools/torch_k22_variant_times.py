"""Times K2.2's instantiations (clraytracer_tpu_torch/csrc/render.cu) at the
option cells' shapes, 1920x1080 and 2 bounces, in the tree it is run from,
and prints render.cu's ptxas report (empty when the build was cached).

    python3 tools/torch_k22_variant_times.py

One JSON line per case: the default frame on ``sphere`` (a), atlas mode 1
(h), GI (j), shadows (k) and shadows + GI on the ground scene: the median
and range of 20 launches after 3 warm-ups (CUDA events), and the kernel
against its plain version on a 128x64 strip of the same camera. To compare
two builds of the kernel (for example another ``__launch_bounds__``),
unpack each tree into a gitignored directory and run the script from each
in turns, in one call on one card. Needs a CUDA card.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

CASES = (
    ("a", "sphere", {}),
    ("h", "atlas", {}),
    ("j", "sphere", {"gi_seed": 0}),
    ("k", "ground", {"shadows": True}),
    ("k_gi", "ground", {"shadows": True, "gi_seed": 0}),
)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_k22_variant_times: CUDA is not available", file=sys.stderr)
        return 2
    from clraytracer_tpu_torch.ops import render_fused as rf
    from clraytracer_tpu_torch.runtime import kernels

    kernels.build_all()
    print(json.dumps({"ptxas": cs.ptxas_summary(kernels.build_log.get("render.cu", ""))}))
    dev = torch.device("cuda", 0)
    for tag, spec, kw in CASES:
        scene = cs.option_scene(spec, device=dev)
        frame = cs.option_frame(spec, 1920, 1080)
        args = cs.option_args(scene, frame, 1920, 1080)
        opts = dict(atlas_mode=rf.atlas_mode_of(scene), **kw)
        ms, times = cs.event_ms(lambda: rf.render_cuda(*args, **opts), 20, 3)
        sargs = cs.option_args(scene, frame, 128, 64)
        chk = cs.compare_options(rf.render_cuda(*sargs, **opts),
                                 rf.render_fused_plain(*sargs, dev, **opts),
                                 opts["atlas_mode"], "gi_seed" in kw)
        print(json.dumps({"cell": tag, "ms": ms, "min": times[0], "max": times[-1],
                          "ok": chk["ok"], "differ": chk["rays_differing"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
