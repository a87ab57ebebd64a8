"""Multi-view inverse rendering: one differentiable step a view, the views
of the configuration's path in turn, every leaf's gradient read. The
answers compared: a seeded sample of the window's steps, each step's loss
and the norm of every leaf's gradient."""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from rtbench import check, port
from rtbench.loops import Outcome, Profile, Reservoir, Run, breakdown, free, scene_spec, sync
from rtbench.poses import path, start


def measure(run: Run) -> Outcome:
    cfg, tr, dev = run.config, run.traffic, run.device
    spec = scene_spec(run)
    scene = port.builder(spec).build(device=dev)
    n_views = int(tr["views"])
    views = path(cfg["path"], n_views)
    s0 = start(run.seed, n_views)
    w, h = int(cfg["width"]), int(cfg["height"])
    gen = torch.Generator(device=dev)
    gen.manual_seed(run.seed)
    targets = torch.rand((n_views, h, w, 3), generator=gen, device=dev)
    frames_in = [port.frame_inputs(cfg, v, dev) for v in views]

    def one(i: int):
        v = (s0 + i) % n_views
        loss, grads = port.step(scene, frames_in[v], cfg, targets[v], dev)
        # every leaf's gradient is read
        total = loss + sum(g.float().sum() for g in grads.values())
        return loss, grads, bool(torch.isfinite(total))

    for i in range(-2, 0):
        one(i)
    sync(dev)
    setup_s = time.perf_counter() - run.t0

    kept = Reservoir(int(tr["check_steps"]), run.seed, 6)
    bad = 0
    prof = Profile(run, int(tr["trace_from"]), int(tr["trace_steps"]))
    t_start = time.perf_counter()
    i = 0
    while True:
        prof.before(i)
        try:
            if run.trace:
                with torch.profiler.record_function("rtbench.step"):
                    loss, grads, ok = one(i)
            else:
                loss, grads, ok = one(i)
        except Exception as e:  # a failed step counts, the loop goes on
            if bad == 0:
                run.first_error = repr(e)
            loss, grads, ok = None, None, False
        t1 = time.perf_counter()
        prof.after(i)
        bad += not ok
        if ok:
            kept.offer(lambda: (i, float(loss), grads))
        i += 1
        if t1 - t_start - prof.paused >= run.seconds:
            break
    prof.close(i - 1)
    window = t1 - t_start
    sync(dev)
    memory_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    outcome = Outcome(attempted=i, failed=bad,
                      end_to_end={"setup_s": setup_s, "step_ms": window * 1e3 / i},
                      numbers={}, context={"kind": "steps", "steps": i},
                      memory_peak_bytes=int(memory_peak))
    if run.trace:
        tl = prof.timeline()
        outcome.breakdown, outcome.busy_s = breakdown(tl)
        outcome.window_s = prof.window_s
        outcome.context.update(timeline=tl, units=prof.count, window_s=prof.window_s)

    answers = [(k, loss, {n: check.leaf_norm(g) for n, g in grads.items()})
               for k, loss, grads in kept.items]
    del scene, kept, grads
    free(dev)

    from rtbench.reference.frame import Scene as RefScene
    from rtbench.reference.step import loss_and_grads

    ref = RefScene(spec, dev)
    loss_gap, grad_gap, stray = [], [], []
    for k, loss, norms in answers:
        v = (s0 + k) % n_views
        ref_loss, ref_grads = loss_and_grads(ref, views[v], cfg, targets[v])
        ref_norms = {n: check.leaf_norm(g) for n, g in ref_grads.items()}
        del ref_grads
        loss_gap.append(abs(loss - ref_loss) / abs(ref_loss))
        g, s, _ = check.leaf_gaps(norms, ref_norms)
        grad_gap.append(g)
        stray.append(s)
        med = check.nonzero_median(ref_norms)
        outcome.context.setdefault("leaf_gaps", []).append(
            {n: abs(norms[n] - r) / max(r, med) for n, r in ref_norms.items() if n in norms})
    outcome.numbers = {"loss_gap": max(loss_gap, default=math.inf),
                       "grad_gap": max(grad_gap, default=math.inf),
                       "stray_grad": max(stray, default=math.inf)}
    return outcome


def control(run: Run, low=torch.bfloat16) -> dict:
    """The steps' numbers of the low-precision reference step against the
    float32 one, on views drawn as a window would draw them. The control
    differentiates in bfloat16 (the recompute, the shading, the loss and
    the backward) and finds its hits, a discrete choice with no gradient,
    in float32."""
    from rtbench.reference.frame import Scene
    from rtbench.reference.step import loss_and_grads

    cfg, tr, dev = run.config, run.traffic, run.device
    spec = scene_spec(run)
    views = path(cfg["path"], int(tr["views"]))
    s0 = start(run.seed, len(views))
    w, h = int(cfg["width"]), int(cfg["height"])
    gen = torch.Generator(device=dev)
    gen.manual_seed(run.seed)
    targets = torch.rand((len(views), h, w, 3), generator=gen, device=dev)
    ref, ctl = Scene(spec, dev), Scene(spec, dev, low)
    rng = np.random.default_rng([run.seed, 9])
    loss_gap, grad_gap, stray = [], [], []
    for k in rng.integers(0, len(views), int(tr["check_steps"])).tolist():
        v = (s0 + k) % len(views)
        rl, rg = loss_and_grads(ref, views[v], cfg, targets[v])
        rn = {n: check.leaf_norm(g) for n, g in rg.items()}
        del rg
        cl, cg = loss_and_grads(ctl, views[v], cfg, targets[v], low, hit_scene=ref)
        cn = {n: check.leaf_norm(g) for n, g in cg.items()}
        del cg
        loss_gap.append(abs(cl - rl) / abs(rl))
        g, s, _ = check.leaf_gaps(cn, rn)
        grad_gap.append(g)
        stray.append(s)
    return {"loss_gap": max(loss_gap), "grad_gap": max(grad_gap), "stray_grad": max(stray)}
