"""K2.2's work on one pose of a benchmark configuration: the six work
counters (``ops.trace.COUNTER_NAMES``) of one frame at the configuration's
size, by bounce and a ray, the instance level's engagement, and the
kernel's device ms, for the tree it is run from.

    cd <root of a tree> && python3 <path>/tools/torch_instance_walk.py \
        [--config instances401] [--config museum160k] [--pose 0] [--seed 1]

The scene is the benchmark's (``rtbench/scenes``), built through the
port's ``SceneBuilder`` (``rtbench.port.builder``), the pose one of the
configuration's camera path (``rtbench.poses.path`` over 240 poses, the
``walk`` mix's). One JSON line a configuration: the frame's counters and
``ray_transforms`` and ``boxes`` a camera ray, bounce 0 alone and bounce 1
(the frame less bounce 0, over bounce 0's shaded hits), the instance
level's engagement by bounce (``engagement``: instances a live ray enters,
and the pass share, ray transforms over instances x live rays), and the
device ms of the frame's launch and of bounce 0's
(``chip_smoke.device_ms``). A configuration with sun shadows on
(``render.enable_shadows``, ``museum160k-shadows``) launches the shadow
instantiation and adds ``shadow_walk``: the shadow walk's own counters
(``shadow_counters``) a shadow ray (one a bounce-0 hit), the share of
those rays that are occluded (K2.1 on the same rays,
``chip_smoke.shadowed_hits``), and K2.2's device ms with and without
shadows in turns. Needs the card.
"""


from __future__ import annotations

import argparse
import importlib
import json
import sys
from pathlib import Path


def engagement(split: dict, n_inst: int, pixels: int) -> dict:
    """The instance level's engagement by bounce, from ``bounce_split``'s
    counters: a bounce's live rays (bounce 0: the frame's pixels, its pad
    lanes are dead; bounce 1: bounce 0's shaded hits), the instances a live
    ray enters (ray transforms over live rays) and the pass share, ray
    transforms over ``n_inst`` x live rays (1 less it is the share that
    the instance level skips)."""
    out = {}
    for name, live in (("bounce0", pixels), ("bounce1", split["bounce1"]["rays"])):
        xf = split[name]["counts"]["ray_transforms"]
        out[name] = {"live_rays": live,
                     "entered_per_ray": xf / live if live else None,
                     "pass_share": xf / (n_inst * live) if live else None}
    return out


def shadow_walk(args, opts: dict, frame, counts: list, bounce0_hits: int, w: int,
                h: int) -> dict:
    """The shadow walk of a frame with shadows on: its counters a shadow
    ray, the occluded share, and K2.2's device ms with and without the walk
    in turns (three rounds)."""
    from chip_smoke import camera_rays, device_ms, shadowed_hits
    from clraytracer_tpu_torch.ops import render_fused as rf
    from clraytracer_tpu_torch.ops.trace import COUNTER_NAMES

    shadow = dict(zip(COUNTER_NAMES, counts))
    in_shadow, hits = shadowed_hits(args[0], camera_rays(w, h, args[0].planes.device, frame)[0],
                                    args[2].sun)
    per = lambda k: shadow[k] / bounce0_hits if bounce0_hits else None
    bare = dict(opts, shadows=False)
    turns = [[device_ms(lambda: rf.render_cuda(*args, **o)) for o in (opts, bare)]
             for _ in range(3)]
    on = sorted(t[0] for t in turns)[1]
    off = sorted(t[1] for t in turns)[1]
    return {"counts": shadow, "shadow_rays": bounce0_hits,
            "box_tests_per_shadow_ray": per("boxes"),
            "tri_tests_per_shadow_ray": per("triangles"),
            "instances_entered_per_shadow_ray": per("ray_transforms"),
            "node_steps_per_shadow_ray": per("node_steps"),
            "occluded_share": in_shadow / hits if hits else None, "k2_1_hits": hits,
            "k22_device_ms_turns": turns, "k22_device_ms": on, "k22_no_shadows_device_ms": off,
            "share_of_k22": (on - off) / on}


def walk(name: str, pose_index: int, seed: int) -> dict:
    import torch

    from chip_smoke import bounce_split, device_ms, option_args
    from clraytracer_tpu_torch.ops import render_fused as rf
    from clraytracer_tpu_torch.ops.trace import COUNTER_NAMES
    from rtbench import port
    from rtbench.cells import HERE
    from rtbench.poses import path

    dev = torch.device("cuda", 0)
    cfg = json.loads((HERE / "configs" / f"{name}.json").read_text())
    spec = importlib.import_module(f"rtbench.scenes.{cfg['scene']}").build(cfg, seed)
    scene = port.builder(spec).build(device=dev)
    pose = path(cfg["path"], 240)[pose_index]
    frame = port.frame_inputs(cfg, pose, dev)
    w, h, bounces = int(cfg["width"]), int(cfg["height"]), int(cfg["bounces"])
    shadows = bool(cfg.get("render", {}).get("enable_shadows", False))
    opts = dict(atlas_mode=rf.atlas_mode_of(scene), shadows=shadows)
    args = option_args(scene, frame, w, h, bounces)
    args0 = option_args(scene, frame, w, h, 1)
    counts = []
    shadow_counts = torch.zeros(len(COUNTER_NAMES), dtype=torch.int64, device=dev)
    for a in (args, args0):
        c = torch.zeros(len(COUNTER_NAMES), dtype=torch.int64, device=dev)
        rf.render_cuda(*a, c, **opts, **(
            {"shadow_counters": shadow_counts} if shadows and a is args else {}))
        counts.append(c.cpu().tolist())
    rays = args[6] * 128
    frame_counts = dict(zip(COUNTER_NAMES, counts[0]))
    split = bounce_split(counts[0], counts[1], rays)
    extra = {}
    if shadows:
        extra["shadow_walk"] = shadow_walk(args, opts, frame, shadow_counts.cpu().tolist(),
                                           int(counts[1][3]), w, h)
    return {"config": name, "pose": pose_index, "instances": len(spec.instances),
            "width": w, "height": h, "camera_rays": rays, "counts": frame_counts,
            "ray_transforms_per_camera_ray": frame_counts["ray_transforms"] / rays,
            "boxes_per_camera_ray": frame_counts["boxes"] / rays,
            "by_bounce": split,
            "instance_level": engagement(split, len(spec.instances), w * h),
            "k22_device_ms": device_ms(lambda: rf.render_cuda(*args, **opts)),
            "k22_bounce0_device_ms": device_ms(lambda: rf.render_cuda(*args0, **opts)),
            **extra, "card": torch.cuda.get_device_name(dev)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="torch_instance_walk.py")
    ap.add_argument("--config", action="append", default=None)
    ap.add_argument("--pose", type=int, default=0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("torch_instance_walk.py: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path.cwd()))
    for name in args.config or ["instances401", "museum160k"]:
        print(json.dumps(walk(name, args.pose, args.seed)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
