"""The editor's frame loop: each frame a tick (one instance turned a step),
a camera pose from the configuration's closed path, a render under the
watchdog, and a hover pick every so often. The answers compared: a seeded
sample of pixels of a seeded sample of the window's frames, and a seeded
sample of its picks."""

from __future__ import annotations

import math
import time
import types

import numpy as np
import torch

from rtbench import check, port
from rtbench.loops import Outcome, Profile, Reservoir, Run, breakdown, free, p95, scene_spec, sync
from rtbench.poses import path, start
from rtbench.scenes.spec import rotation_y


def measure(run: Run) -> Outcome:
    cfg, tr, dev = run.config, run.traffic, run.device
    spec = scene_spec(run)
    eng = port.engine(spec, cfg, dev, float(tr["watchdog_ms"]))
    poses = path(cfg["path"], int(tr["poses"]))
    s0 = start(run.seed, len(poses))
    k_anim = int(cfg["animate"]["instance"])
    base = spec.instances[k_anim].transform
    deg = float(cfg["animate"]["deg_per_tick"])
    w, h = int(cfg["width"]), int(cfg["height"])
    pick_rng = np.random.default_rng([run.seed, 3])
    every = int(tr["pick_every"])

    def pose_of(i: int):
        return poses[(s0 + i) % len(poses)]

    def transform_of(i: int) -> np.ndarray:
        return (rotation_y(math.radians(deg * i)) @ base).astype(np.float32)

    def one(i: int, xy):
        eng.set_instance_transform(k_anim, transform_of(i))
        eng.tick()
        port.set_pose(eng, pose_of(i))
        img = eng.render()
        return img, (eng.pick(*xy) if xy is not None else None)

    finite = torch.ones(1 << 16, dtype=torch.bool, device=dev)
    # warm-up: the cell's shapes (the frame, a one-ray pick, the check of
    # the image), past the engine's watchdog-exempt frames
    for i in range(-3, 0):
        img, _ = one(i, (w / 2.0, h / 2.0) if i == -1 else None)
        finite[i] = torch.isfinite(img).all()
    finite.fill_(True)
    sync(dev)
    setup_s = time.perf_counter() - run.t0

    frames_kept = Reservoir(int(tr["check_frames"]), run.seed, 4)
    picks, times, raised = [], [], []
    spans = port.Spans() if run.trace else None
    host_ms = []
    prof = Profile(run, int(tr["trace_from"]), int(tr["trace_frames"]))
    if spans is not None:
        spans.__enter__()
    t_start = time.perf_counter()
    i = 0
    try:
        while True:
            xy = None
            if i % every == every - 1:
                xy = (float(pick_rng.integers(w)), float(pick_rng.integers(h)))
            prof.before(i)
            t0 = time.perf_counter()
            try:
                if spans is not None:
                    # the host spans are read outside the profiled frames,
                    # whose recording slows the host
                    with torch.profiler.record_function("rtbench.frame"):
                        img, hit = one(i, None)
                        if not prof.profiled(i):
                            host_ms.append((spans.returned - t0) * 1e3)
                        if xy is not None:
                            tp = time.perf_counter()
                            with torch.profiler.record_function("rtbench.pick"):
                                hit = eng.pick(*xy)
                            if not prof.profiled(i):
                                spans.add("rtbench.pick", time.perf_counter() - tp)
                else:
                    img, hit = one(i, xy)
                if i < finite.shape[0]:
                    finite[i] = torch.isfinite(img).all()
            except Exception as e:  # a failed frame counts, the loop goes on
                raised.append(i)
                if len(raised) == 1:
                    run.first_error = repr(e)
                img, hit = None, None
            t1 = time.perf_counter()
            prof.after(i)
            times.append(t1 - t0)
            if img is not None:
                frames_kept.offer(lambda: (i, img))
            if hit is not None:
                picks.append((i, xy, hit))
            i += 1
            if t1 - t_start - prof.paused >= run.seconds:
                break
    finally:
        prof.close(i - 1)
        if spans is not None:
            spans.__exit__()
    window = t1 - t_start
    sync(dev)
    bad = set(raised) | set(np.nonzero(~finite[:min(i, finite.shape[0])].cpu().numpy())[0].tolist())
    ms = [math.inf if k in bad else t * 1e3 for k, t in enumerate(times)]
    end_to_end = {"setup_s": setup_s, "frame_ms": window * 1e3 / i, "frame_p95_ms": p95(ms)}
    memory_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    outcome = Outcome(attempted=i, failed=len(bad), end_to_end=end_to_end, numbers={},
                      context={"kind": "frames", "frames": i, "picks": len(picks)},
                      memory_peak_bytes=int(memory_peak))
    if run.trace:
        tl = prof.timeline()
        traced = range(prof.first, prof.first + prof.count)
        outcome.breakdown, outcome.busy_s = breakdown(tl)
        outcome.window_s = prof.window_s
        outcome.context.update(timeline=tl, units=prof.count, window_s=prof.window_s,
                               engine_host_ms=host_ms,
                               pick_ms=[s * 1e3 for s in spans.seconds.get("rtbench.pick", [])],
                               traced_poses=[pose_of(k) for k in traced],
                               traced_transforms=[transform_of(k) for k in traced])

    # the answers to compare: a seeded sample of pixels of each kept frame
    from rtbench.reference.frame import sample_pixels

    px, py = sample_pixels(run.seed, int(tr["check_pixels"]), w, h, dev)
    kept = [(k, img[py.long(), px.long()].float().cpu()) for k, img in frames_kept.items]
    sel = np.random.default_rng([run.seed, 5]).permutation(len(picks))[:int(tr["check_picks"])]
    kept_picks = [picks[j] for j in sorted(sel)]
    del eng, frames_kept, img, finite
    free(dev)

    from rtbench.reference.frame import Scene as RefScene

    ref = RefScene(spec, dev)
    off = []
    for k, got in kept:
        ref.set_transform(k_anim, transform_of(k))
        want = ref.frame_pixels(pose_of(k), cfg, px, py).float().cpu()
        off.append(check.pixels_off(got, want))
    disagree = []
    for k, xy, hit in kept_picks:
        ref.set_transform(k_anim, transform_of(k))
        disagree.append(check.pick_disagrees(hit, ref.pick(pose_of(k), cfg, *xy)))
    outcome.numbers = {"pixels_off": max(off) if off else math.inf,
                       "picks_off": float(np.mean(disagree)) if disagree else math.inf}
    if run.trace:
        from rtbench import roofline

        outcome.context["frame_bytes"] = roofline.frame_bytes(
            ref, cfg, outcome.context["traced_poses"], outcome.context["traced_transforms"],
            k_anim)
    return outcome


def control(run: Run, low=torch.bfloat16) -> dict:
    """The frames' numbers of the low-precision reference against the
    float32 one, on frames and picks drawn as a window would draw them."""
    from rtbench.reference.frame import Scene, sample_pixels

    cfg, tr, dev = run.config, run.traffic, run.device
    spec = scene_spec(run)
    poses = path(cfg["path"], int(tr["poses"]))
    s0 = start(run.seed, len(poses))
    k_anim = int(cfg["animate"]["instance"])
    base = spec.instances[k_anim].transform
    deg = float(cfg["animate"]["deg_per_tick"])
    w, h = int(cfg["width"]), int(cfg["height"])
    rng = np.random.default_rng([run.seed, 8])
    ref, ctl = Scene(spec, dev), Scene(spec, dev, low)
    px, py = sample_pixels(run.seed, int(tr["check_pixels"]), w, h, dev)
    off, disagree = [], []
    for k in rng.integers(0, 4 * len(poses), int(tr["check_frames"])).tolist():
        m = (rotation_y(math.radians(deg * k)) @ base).astype(np.float32)
        pose = poses[(s0 + k) % len(poses)]
        for s in (ref, ctl):
            s.set_transform(k_anim, m)
        off.append(check.pixels_off(ctl.frame_pixels(pose, cfg, px, py).float().cpu(),
                                    ref.frame_pixels(pose, cfg, px, py).float().cpu()))
    for _ in range(int(tr["check_picks"])):
        k = int(rng.integers(0, 4 * len(poses)))
        xy = (float(rng.integers(w)), float(rng.integers(h)))
        m = (rotation_y(math.radians(deg * k)) @ base).astype(np.float32)
        pose = poses[(s0 + k) % len(poses)]
        for s in (ref, ctl):
            s.set_transform(k_anim, m)
        got = types.SimpleNamespace(**ctl.pick(pose, cfg, *xy))
        disagree.append(check.pick_disagrees(got, ref.pick(pose, cfg, *xy)))
    return {"pixels_off": max(off), "picks_off": float(np.mean(disagree))}
