"""Smoke run of clraytracer_tpu_torch on one NVIDIA card (H100, sm_90a).

    python3 chip_smoke.py [--out results.json]

Builds the CUDA kernels from csrc/ (one nvcc per source, in parallel),
holds each kernel against its plain PyTorch version on the card, drives the
main paths (``render.render_frame``: the default frame on three scenes,
the fused frame's options on six more cells and the two-phase path on
four; ``render.trace_planar`` through K2.2's ray mode;
``render_fused_camera(split_rebin=True)`` through K2.2's carry on four;
``diff.image_loss_and_grads``, the differentiable step; the multi-device
layer, ``parallel.render_sharded``, ``train_step_sharded``,
``render_sharded_2d`` and ``cli sweep``, over 1 to 4 ranks) and prints
one JSON line per phase:

1. device: card name and power limit, torch/CUDA versions, build seconds,
   registers and spills per kernel and per K2.2 instantiation (the carry's
   three included)
2. trace: K2.1 vs ``trace_plain`` on ``two`` (320x240 camera rays + 4096
   seeded random rays), with and without a live mask, and ``return_slots``
3. fused: K2.2 vs ``render_fused_plain`` on ``two`` and ``sphere`` at
   320x240 (at most FRAME_MISMATCH_MAX rays over 1e-5 on the nine planes);
   options: every option instantiation of K2.2 (atlas modes 0/1/2 x
   shadows x GI, the shadowed ground, the four jittered samples of a
   ``samples=4`` frame) vs its plain version at 320x240 (pool indices
   exact, at most FRAME_MISMATCH_MAX rays over 1e-5, GI included); every
   ray-mode instantiation on the camera's tiled rays bit for bit equal to
   camera mode, and on rays with their own origins and directions
   (``jittered_rays``) vs its plain version on the same rays; the carry's
   instantiations (carry-out without and with shadows, carry-in on the
   rows the re-bin gives, over 1 and 2 bounces) vs their plain versions
4. main path: ``render.render_frame`` on (a) ``sphere`` 4224 tris at
   1920x1080, (b) ``two`` at 1249x720, (c) ``sphere --tris 1000000`` at
   1920x1080; frame ms (CUDA events, median of 20 after 3 warm-ups),
   Mrays/s = W*H*bounces/dt (no clamp), the host's time to issue a frame,
   K2.2 launches per frame (must be 1), work counts per frame, K2.2 and
   the frame's torch tail piece by piece, K2.2's bounce 0 alone, K2.1 on
   the frame's camera rays and on its hits and its misses alone, finite
   image and its mean, and both kernels against their plain versions on
   that configuration's scene (K2.1 on 4096 seeded camera rays, K2.2 on a
   128x64 strip). Then (d) the hit-query entry ``ops.trace.trace`` on
   (a)'s scene and 1920x1080 camera rays: one K2.1 launch per call (and
   no K2.2). Then the option cells, each through ``render.render_frame``
   at 1920x1080: (h) ``atlas`` (bench.py's sphere with imported textures,
   atlas mode 1), (i) ``atlas65`` (mode 2), (j) ``sphere`` with GI
   (bench.py's gi row), (k) the shadowed ground, (l) and (m) (a)'s and
   (c)'s spheres with shadows (in each shadow cell the bounce-0 hits in
   shadow must be > 0); frame ms, K2.2 ms, the tail piece by piece, the
   host's time to issue a frame, K2.2's six counters and bound (the shadow
   walk's counts apart, and the same frame without shadows timed beside),
   the device's idle share and time by kernel, one launch of the cell's
   instantiation per frame, K2.2 vs its plain version at 1920x1080 (for
   (m)'s million triangles on a band of 16 image rows of its 1920x1080
   launch, which must hold hits in shadow) and on a strip.
   Then the two-phase cells through ``render.render_frame`` at 1920x1080,
   (n) ``glass`` with refraction, (o) (k)'s ground with float colours and
   shadows, (p) (a)'s sphere with material shading and GI, (q)
   ``sphere65`` (65 materials, all procedural): frame ms, the host's time
   to issue a frame, K2.1 launches per frame (one per bounce and one for
   the shadow rays; no K2.2), a finite image, and every K2.1 launch of one
   frame (recorded with its live mask) against ``trace_plain`` on the same
   inputs, each timed beside its plain version. Then (r)
   ``render.trace_planar`` on (a)'s scene and 1920x1080 camera rays with
   integer colours: one K2.2 ray-mode launch per call and no K2.1, the
   launch against its plain version on the same rays (and with GI), its
   ms, counters and bound. Then (s) ``render_fused_camera(split_rebin=
   True)`` at 1920x1080 on (a)'s and (c)'s spheres and (k)'s ground
   without (k0) and with shadows: two K2.2 launches per frame (carry-out,
   carry-in) and no K2.1 (counts from zero), the split and the unsplit
   frame in turns, each launch's ms and device ms, the re-bin glue's ms,
   the carry-in launch's counters beside the unsplit frame's bounce-1
   share, the rays that differ from the unsplit frame (at most
   FRAME_MISMATCH_MAX), both launches against their plain versions (on a
   band above PLAIN_FULL_MAX_TRIS triangles) and their bounds
5. profile: torch.profiler over 10 frames of (a), device time by kernel
   and the device's idle share against (a)'s unprofiled frame time
6. diff: the differentiable step ``diff.image_loss_and_grads``.
   (e) ``sphere`` 4224 tris at 1920x1080, 2 bounces, L2 against black
   (the JAX bench's grads row): step ms (CUDA events, median of 10 after
   2 warm-ups), fwd+bwd Mrays/s = W*H*bounces/step, launches per step
   (K2.1, K2.3 and K2.4 twice each), peak memory, finite gradients that
   are nonzero on albedo, v0 and the instance transforms; K2.3 (bit-exact)
   and K2.4 (within 1e-5 * sum|g| + 1e-7) against their plain versions and
   library calls on the step's own inputs, timed per call and on the
   card (``device_ms``); torch.profiler over 3 steps.
   (f) the card's step against the CPU step (plain versions) on ``two``
   and ``sphere`` at 160x120. (g) 5 Adam steps of ``cli.fit`` on
   ``two``'s albedo at 1249x720: the loss falls
7. kernels: each kernel against its plain version at (a)'s shapes, the
   six work counters of K2.1/K2.2 on every main-path configuration and
   their registers and spill bytes (``-Xptxas -v``), then the kernels
   line: per kernel its TPU counterpart, launches on its path, error
   against the plain version, ms (events around one call, the host's
   issue included; device_ms beside it: the card's time, ``device_ms``),
   plain ms, bound ms (K2.1/K2.2: the bytes the scene's data needs,
   ``walk_bytes``, and this run's counts; the phase lines print beside it
   the bound from the per-ray walk's counts), library ms (per call;
   library_device_ms beside it);
   one entry per K2.2 instantiation of the option cells, its bound
   counting its deferred planes and its shading; K2.1 on the two-phase
   path (timed at (o)'s shadow rays) and K2.2 in ray mode (at (r)'s rays,
   its bound counting its 24 bytes of input a ray); the carry-out (76
   bytes out a ray), carry-out with shadows and carry-in (112 bytes a ray:
   rays and carry in, 9 planes out) instantiations at (s)'s shapes

Between 4 and 5, (t) imported: a museum-class scene written as files
(``write_museum``: three OBJ/MTL meshes of 161,360 triangles from the
port's procedural meshes, quad faces and usemtl groups, 42 materials with
45 PNG maps of 512x512, written with every row filter), one mesh through
``save_clm`` and one through the ``.clmz`` cache, placed as the JAX
``museum`` scene places its three: the CLI's ``render --scene <obj>``,
``snapshot`` and ``render --scene <.clsnap.npz>`` (byte-equal PNGs), then
``render.render_frame`` at 1920x1080 with the default RenderConfig (one
K2.2 atlas-1 launch a frame, no K2.1, counts from zero); the host's import
seconds by step (OBJ parser and image decoder named), the hit share of the
camera rays (at least half), frame ms, the host's issue ms, K2.2's ms and
bound, its ``_finish_frame`` tail, the idle share, K2.2 against its plain
version on a 16-row band of its own launch, the snapshot's seconds, bytes
and bit-equal frame; the reference tracers on the card: ``render_frame``
through ``trace_wavefront`` at 320x240, ``trace_wavefront``, ``trace_bvh``
and ``trace_brute`` on 4096 seeded camera rays against K2.1 (rays that
differ counted; brute within FRAME_MISMATCH_MAX). The kernels line adds
(t)'s launches to the atlas-1 instantiation's entry.

After (t), (u) engine: ``engine.Engine`` on (a)'s scene at 1920x1080,
``tracer="best"``, the reference's 80 ms frame watchdog armed: each frame
turns instance 0 (``set_instance_transform``), moves the camera
(``update_camera``), ``tick``s (instance upload, ``refresh_packed``),
renders and ends the frame; counts from zero (one K2.2 launch a frame, no
K2.1); frame ms (CUDA events around the whole frame), the host's issue,
tick ms; the last frame bit-equal to ``render_frame`` on a scene built
afresh from the builder's state; a 16-row band of an animated frame's
launch against its plain version; ticks on (c)'s 1,002,000 triangles with
the traversal's geometry tables shown to be the same tensors; picking:
4096 seeded screen points through ``raycast(tracer=trace_best)`` (one K2.1
launch) and 64 single ``Engine.pick`` calls, counts from zero, the
raycast against ``trace_brute`` (at most FRAME_MISMATCH_MAX rays
differing), K2.1 on 1, 3 and 33 of those rays exact against its plain
version, the pick's ms through K2.1 and through ``trace_bvh``; the bench
twin's default and ``--grads`` rows at 1920x1080 (JSON lines); the live
viewer as a process on the card at 480x320 (five ``/frame`` PNGs decoded,
X-Frame rising, ``/pick`` on the sphere, ``/material``, a frame after the
edit). The kernels line adds (u)'s launches to the K2.2 and K2.1 entries.

After 6, (v) sharded: the multi-device layer (``parallel/``) on
``torch.distributed``. (v1) ``render_sharded`` on (a) at 1920x1080, (v2)
on (a)'s scene at 320x239 (the last row window past H), (v3) on
``sphere65`` at 1920x1080 (two-phase rows, K2.1 a bounce), (v4)
``train_step_sharded`` at (e)'s configuration against seeded numpy noise,
lr 1.0: each in process on a 1-rank NCCL group, then on 2 gloo ranks
sharing the card (``run_world``: ranks started by torch.multiprocessing
after the parent's build, a file rendezvous, a timeout; a rank that fails
or hangs fails the phase); counts from zero on every rank (one K2.2 launch
a rank and frame; K2.1 twice a frame in (v3); K2.1, K2.3 and K2.4 twice a
step), frame and step ms (CUDA events, every rank its own), the
all-gather and the all-reduce alone, every rank's frame bit-equal to the
1-rank frame and at most FRAME_MISMATCH_MAX pixels over 1e-5 from
``render_frame``, (v1)'s frame beside ``render_frame``'s in turns; (v4)'s
loss and albedo of 2 ranks within rtol 1e-4 of 1 rank and the gradient
the update implies against ``image_loss_and_grads`` (rtol 2e-2, atol
1e-5). (v5) 4 gloo ranks: ``render_sharded_2d`` on a 2x2 mesh (rows x
instance blocks) of the geometry suite's 5-instance scene at 320x240
(cut: the geo tracer is the plain-torch wavefront walk) bit-equal to
``render_frame(tracer=trace_wavefront)``, and the geo tracer's records
on 4096 seeded rays equal to ``trace_wavefront``'s. (v6) ``cli sweep`` on
(a) at 1080p in process (1 NCCL rank), then as 2 gloo processes on the
card (a mechanism check: two ranks on one card measure no scaling). Then
each kernel of the path against its plain version at the last rank's
shapes, timed, with its bound; the kernels line adds their entries.

then the card's ``name, power.limit`` line and, last, the ``{"ok": true,
"device": ...}`` line. Any failure exits non-zero without that line.
Imports no JAX and nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

# published H100 SXM peaks (NVIDIA data sheet): FP32 outside the tensor
# cores, HBM3 bandwidth
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
# f32 operations per unit of work, counted from csrc/ (a division or a
# square root counts as one); the first four of the kernels' int64[6]
# counters (ops.trace.COUNTER_NAMES) count the units: box tests, triangle
# tests, ray transforms, interpolated hits. The last two count the warps'
# 32-child node tests and the clusters they staged in shared memory.
BOX_OPS = 27  # slab: 6 sub + 6 mul + 12 min/max + 3 compares
TRI_OPS = 45  # plane test: den 5 + b_n 6 + t 2 + u 13 + v 13 + u+v 1 + 5 cmp
XFORM_OPS = 36  # ray to object space: origin 18 + direction 15 + 3 reciprocals
INTERP_OPS = 27  # w0 2 + five 3-term interpolations of 5
# render.cu per shaded hit after interpolation: world normal 15, object ray
# 33, normalise 9, material row 4, checker texel 17, colour 24, Phong and
# reflection 86
SHADE_OPS = 188
RAYGEN_OPS = 59  # render.cu per camera ray: NDC 7, invProj 24, invView 18, norm 10
# per shaded hit by atlas mode: mode 0 is SHADE_OPS; the atlas modes skip
# the texel and colour (41) and the colour terms of the Phong sum (15), and
# add the deferred planes: mode 1 the pool index 6, colour bytes 12 and
# coefficients 9 (159); mode 2 reads no material row (-4) and emits only
# the coefficients 9 (137)
SHADE_OPS_BY_MODE = {0: SHADE_OPS, 1: 159, 2: 137}
# render.cu gi_sample per shaded hit: two uniforms 4, sin 4, phi 1, cos and
# sin 2, their products 2, helper test 2, tangent 6 + normalise 10,
# binormal 9 + normalise 10, direction 15, side test 5 + flip 3, weight 2;
# the throughput product 3 (6 in mode 0)
GI_OPS = 86

# Those four counts as the per-ray walk (one thread per ray, the hierarchy
# in index order) that csrc/traverse.cuh's warp walk replaced ran them at
# the main path's shapes (this script, NVIDIA H100 80GB HBM3, 700 W), keyed
# by (kernel, configuration, triangles). The phase lines print the bound
# they give beside this run's, so a walk that needs more tests than the one
# it replaced shows there; the kernels line holds only this run's numbers.
# Their triangle tests count all 32 slots of a cluster, padding included,
# as the counter did then; this run's count only the real slots.
PER_RAY_WALK_COUNTS = {
    ("K2.2", "a", 4224): (22337367, 14502656, 2179137, 90177),
    ("K2.2", "b", 2220): (5273356, 3669472, 2042510, 48010),
    ("K2.2", "c", 1002000): (166356994, 13883264, 2179296, 90343),
    ("K2.1", "a", 4224): (17438758, 10321312, 2088960, 90177),
}
# The same four counts of (k)'s frame when its shadow ray walked as a
# nearest-hit ray (both walks together; this script on an NVIDIA H100 80GB
# HBM3, 700 W, before the any-hit walk; padding slots counted as above).
# Cell (k)'s line prints the bound they give beside this run's; the
# kernels line holds only this run's.
NEAREST_SHADOW_WALK_COUNTS = {
    ("K2.2", "k", 198): (13536618, 48518176, 9232436, 1304787),
}

CAMERA = (0.13, 0.21, 10.0)
SUN = -1.96
CHECK_WH = (320, 240)  # kernel-vs-plain checks (phases 2 and 3)
# per main-path configuration (phase 4): K2.1 on this many seeded camera
# rays of the full frame, K2.2 on one 128-pixel strip of the same camera
CHECK_RAYS = 4096
CHECK_STRIP_WH = (128, 64)
# The kernels and their plain versions pick the same winner by
# construction: the least (t, instance, slot) over the accepted candidates,
# a rule that does not depend on the order a warp visits clusters in, and
# the kernels cull only boxes with tnear > best t. Only a float slab test
# that culls a grazing hit the plain brute force keeps can part them: at
# most this many rays of a frame may differ by more than 1e-5 (K2.2), or
# in (t, slot, instance) (K2.1). The 1% seam allowance holds only against
# the JAX package, in the CPU tests.
FRAME_MISMATCH_MAX = 16
# main-path configurations: (tag, scene, --tris, width, height); (c)'s
# triangle count is TRIS_LARGE (bench.py's large scene)
TRIS_LARGE = 1_000_000
MAIN = (
    ("a", "sphere", 4096, 1920, 1080),
    ("b", "two", 4096, 1249, 720),
    ("c", "sphere", None, 1920, 1080),
)
FRAMES, WARMUP = 20, 3
# K2.2's option cells (phase option_cells), each through render_frame:
# (tag, scene of ``option_scene``, --tris, width, height, RenderConfig keys)
OPTION_CELLS = (
    ("h", "atlas", 4096, 1920, 1080, {}),
    ("i", "atlas65", 4096, 1920, 1080, {}),
    ("j", "sphere", 4096, 1920, 1080, {"enable_gi": True}),
    ("k", "ground", 4096, 1920, 1080, {"enable_shadows": True}),
    # (a)'s and (c)'s spheres with shadows: hits facing away from the sun
    # cast shadow rays through the sphere itself
    ("l", "sphere", 4096, 1920, 1080, {"enable_shadows": True}),
    ("m", "sphere", TRIS_LARGE, 1920, 1080, {"enable_shadows": True}),
)
# The two-phase path's cells (phase twophase_cells), each through
# render_frame: (tag, scene of ``option_scene``, --tris, width, height,
# RenderConfig keys, K2.1 launches per frame: one per bounce, one more for
# the shadow rays)
TWO_PHASE_CELLS = (
    ("n", "glass", 4096, 1920, 1080, {"enable_refraction": True}, 2),
    ("o", "ground", 4096, 1920, 1080, {"integer_colors": False, "enable_shadows": True}, 3),
    ("p", "sphere", 4096, 1920, 1080,
     {"reference_parity_shading": False, "enable_gi": True}, 2),
    ("q", "sphere65", 4096, 1920, 1080, {}, 2),
)
# (r): render.trace_planar with K2.1's tracer and integer colours on (a)'s
# scene and the camera's [3, H, W] rays: one launch of K2.2 in ray mode
RAY_CELL = ("r", "sphere", 4096, 1920, 1080)
# (s): ops.render_fused.render_fused_camera(split_rebin=True), 2 bounces,
# against the unsplit frame: (tag, scene of ``option_scene``, --tris,
# width, height, shadows). (a) and (c) as in MAIN, (k0) and (k) (k)'s
# ground without and with shadows, the mixed-surface procedural class
SPLIT_CELLS = (
    ("a", "sphere", 4096, 1920, 1080, False),
    ("c", "sphere", TRIS_LARGE, 1920, 1080, False),
    ("k0", "ground", 4096, 1920, 1080, False),
    ("k", "ground", 4096, 1920, 1080, True),
)
# Above this many triangles a cell's plain version runs on a band of
# CHECK_BAND_ROWS image rows through the middle of the frame, held against
# those rays of the cell's own launch: its brute force over 1M triangles at
# 1920x1080 passes 2M rays over 31,313 chunks of 32 slots per trace, hours
# on the card
PLAIN_FULL_MAX_TRIS = 100_000
CHECK_BAND_ROWS = 16
GI_SEED = 7  # the seed of the GI checks (phase options)
# a sun behind the sphere as the smoke camera sees it (shadow rays head
# away from the camera, through the sphere): most bounce-0 hits in shadow
BACKLIT_SUN = 0.0
# differentiable step (phase diff): (e) the JAX bench's grads configuration
# (bench.py:217, sphere --tris 4096 → 4224 triangles), (f) card vs CPU at
# DIFF_CHECK_WH, (g) Adam steps of ``fit`` on ``two``'s albedo
DIFF_E = ("e", "sphere", 4096, 1920, 1080)
DIFF_CHECK_WH = (160, 120)
DIFF_G = ("g", "two", 1249, 720, 5)
STEPS, STEP_WARMUP = 10, 2


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def event_ms(fn, reps: int, warmup: int = 3) -> tuple[float, list[float]]:
    """Median ms of ``reps`` calls, each timed with CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2], times


# a spin kernel of this many cycles (about 10 ms on an H100) holds the card
# while the host issues a timed run of calls behind it
SLEEP_CYCLES = 20_000_000


def device_ms(fn, calls: int = 5, runs: int = 5) -> float:
    """A kernel's time on the card: CUDA events around a run of ``calls``
    calls, over ``calls``, the median of ``runs``, each run queued behind a
    spin kernel (``torch.cuda._sleep``) that keeps the card busy while the
    host issues it, so that the events time the card's work alone.
    ``event_ms`` around one call issued to an idle card also counts the
    host's time to issue it: for a kernel of a tenth of a millisecond
    behind a Python wrapper, a large part."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    times.sort()
    return times[len(times) // 2]


def hits_match(ref_hit, got_hit, ref_t, got_t, ref_tri, got_tri) -> dict:
    """tests/test_trace.py::assert_hits_match's rule, on numpy arrays."""
    import numpy as np

    n = ref_hit.size
    mism = int((ref_hit != got_hit).sum())
    both = ref_hit & got_hit
    close = np.isclose(ref_t[both], got_t[both], rtol=1e-4, atol=1e-5)
    same_tri = float((ref_tri[both] == got_tri[both]).mean()) if both.any() else 1.0
    ok = (
        mism <= max(1, 0.01 * n)
        and (close.mean() > 0.99 if close.size else True)
        and same_tri > 0.98
    )
    return {"ok": bool(ok), "hit_mismatch": mism,
            "t_close": float(close.mean()) if close.size else 1.0,
            "same_tri": same_tri}


def walk_bound(key, bytes_moved, counts, camera_rays=0, shade=False) -> dict:
    """A K2.1/K2.2 bound from this run's bytes and counts, with the bound
    the per-ray walk's counts give at the same shapes
    (``PER_RAY_WALK_COUNTS[key]``) printed beside it."""
    from clraytracer_tpu_torch.ops.trace import COUNTER_NAMES

    ms, by = bound(bytes_moved, counts, camera_rays, shade)
    out = {"counts": dict(zip(COUNTER_NAMES, counts)), "bytes": bytes_moved,
           "bound_ms": ms, "bound_by": by}
    old = PER_RAY_WALK_COUNTS.get(key)
    if old is not None:
        out["bound_ms_per_ray_walk_counts"] = bound(bytes_moved, old, camera_rays, shade)[0]
    return out


def walk_bytes(kt, clusters: int, slots: int, ft=None) -> int:
    """Scene bytes a K2.1/K2.2 launch must read: the instance rows and box
    tables once, the plane rows of each of ``clusters`` clusters (those
    that hold a winning triangle: a walk opens at least those, and tests a
    cluster's 32 triangles together, as the hierarchy has no finer box),
    the attribute rows of the ``slots`` winning triangles, and K2.2's
    material and texture rows once."""
    ts = [kt.inst, kt.ranges, kt.hyper_box, kt.super_box, kt.cluster_box]
    if ft is not None:
        ts += [ft.mat_rows, ft.tex]
    row = lambda t: t.shape[1] * t.element_size()
    return (sum(t.numel() * t.element_size() for t in ts)
            + clusters * 32 * row(kt.planes) + slots * row(kt.attrs))


def winners(out) -> tuple[int, int]:
    """(distinct clusters, distinct slots) that hold a winning triangle in
    a K2.1 output [11, n]."""
    import torch

    slots = torch.unique(out[3].view(torch.int32)[out[0].abs() < 1e30])
    return int(torch.unique(slots // 32).numel()), int(slots.numel())


def host_ms(fn, reps: int) -> float:
    """Median host time of one call of ``fn``: its launches issued, the
    device drained before each call."""
    import torch

    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    times.sort()
    return times[len(times) // 2]


def ptxas_summary(log: str) -> list:
    """Registers, spill bytes and static shared memory per kernel, from
    nvcc's ``-Xptxas -v`` report."""
    import re

    out, cur = [], {}
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            cur = {"kernel": m.group(1)}
            out.append(cur)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and cur:
            cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m and cur:
            cur["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", ln)
            cur["smem_bytes"] = int(sm.group(1)) if sm else 0
    return out


def k22_registers(entries: list) -> dict:
    """K2.2's ptxas entries (``ptxas_summary`` of render.cu) by
    instantiation name (``render_fused.variant``, ray mode's with "rays",
    the carry's with "carry_out" / "carry_in"): registers and spill bytes.
    Reads the names with the carry parameter and those before it."""
    import re

    from clraytracer_tpu_torch.ops.render_fused import variant

    out = {}
    for e in entries:
        m = re.search(
            r"(render_kernel|render_shadow_kernel)ILi(\d)ELb(\d)ELb(\d)E(?:Li(\d)E)?E",
            e["kernel"])
        if m:
            carry = {None: None, "0": None, "1": "out", "2": "in"}[m.group(5)]
            name = variant(int(m.group(2)), m.group(1) == "render_shadow_kernel",
                           m.group(3) == "1", m.group(4) == "1", carry)
            out[name] = {k: e.get(k) for k in ("registers", "spill_stores", "spill_loads")}
    return out


def table_bytes(kt, ft=None) -> int:
    ts = [kt.inst, kt.ranges, kt.hyper_box, kt.super_box, kt.cluster_box,
          kt.planes, kt.attrs]
    if ft is not None:
        ts += [ft.mat_rows, ft.tex]
    return sum(t.numel() * t.element_size() for t in ts)


def bound(
    bytes_moved: float, counts, camera_rays: int = 0, shade: bool = False
) -> tuple[float, str]:
    """max(bytes / HBM rate, f32 ops / FP32 peak) in ms. ``counts``: the
    kernel's [boxes, triangles, transforms, hits, ...]; ``camera_rays`` and
    ``shade`` add K2.2's raygen and shading."""
    boxes, tris, xforms, hits = (float(c) for c in counts[:4])
    ops = (
        boxes * BOX_OPS + tris * TRI_OPS + xforms * XFORM_OPS
        + hits * (INTERP_OPS + (SHADE_OPS if shade else 0))
        + camera_rays * RAYGEN_OPS
    )
    t_bytes = bytes_moved / PEAK_BYTES * 1e3
    t_ops = ops / PEAK_F32 * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def camera_rays(width, height, device, frame=None):
    """Screen-tile-ordered camera rays [6, n] of ``frame`` (default: the
    smoke camera) and the smoke camera."""
    import torch

    from clraytracer_tpu_torch.camera import Camera, ray_directions_tiled
    from clraytracer_tpu_torch.config import CameraConfig
    from clraytracer_tpu_torch.ops.render_fused import tile_rows

    cam = Camera.create(CameraConfig(position=CAMERA), width, height)
    src = cam if frame is None else frame
    pos = cam.position if frame is None else frame.camera_position
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32).to(device)
    d = ray_directions_tiled(
        f32(src.inverse_view), f32(src.inverse_projection),
        width, height, tile_rows(width * height),
    ).reshape(3, -1)
    o = f32(pos)[:, None].expand_as(d)
    return torch.cat([o, d]).contiguous(), cam


def compare_trace(got, ref, live=None) -> dict:
    """K2.1's [11, n] output against trace_plain's: the hit rule, at most
    FRAME_MISMATCH_MAX rays not exact in (t, slot, instance), then the
    attributes at rtol 1e-5 / atol 1e-6 wherever both pick the same slot."""
    import numpy as np
    import torch

    gt, rt = got[0].cpu().numpy(), ref[0].cpu().numpy()
    gh, rh = np.abs(gt) < 1e30, np.abs(rt) < 1e30
    gs = got[3].view(torch.int32).cpu().numpy()
    rs = ref[3].view(torch.int32).cpu().numpy()
    case = hits_match(rh, gh, rt, gt, rs, gs)
    gi = got[4].view(torch.int32).cpu().numpy()
    ri = ref[4].view(torch.int32).cpu().numpy()
    # the tie rule makes the winner exact: rays whose t, slot or instance
    # differ at all
    case["rays_not_exact"] = int(((gt != rt) | (gs != rs) | (gi != ri)).sum())
    same = gh & rh & (gs == rs)
    attr = [1, 2, 5, 6, 7, 8, 9, 10]  # u v n xyz uu vv mat
    ga, ra = got[attr].cpu().numpy()[:, same], ref[attr].cpu().numpy()[:, same]
    case["attrs_ok"] = bool(np.allclose(ga, ra, rtol=1e-5, atol=1e-6))
    err = float(np.abs(ga - ra).max()) if same.any() else 0.0
    terr = float(np.abs(gt[same] - rt[same]).max()) if same.any() else 0.0
    case["max_abs_err"] = max(err, terr)
    if live is not None:
        dead = live.cpu().numpy() == 0
        case["dead_lanes_miss"] = bool((gt[dead] == np.float32(-1e30)).all())
    case["ok"] = (case["ok"] and case["attrs_ok"] and case.get("dead_lanes_miss", True)
                  and case["rays_not_exact"] <= FRAME_MISMATCH_MAX)
    return case


def phase_trace(dev, results) -> None:
    import torch

    from clraytracer_tpu_torch.cli import build_scene
    from clraytracer_tpu_torch.ops import trace as tr

    scene = build_scene("two", device=dev)
    kt = tr.kernel_tables(scene)
    cam_rays, _ = camera_rays(*CHECK_WH, dev)
    g = torch.Generator(device="cpu").manual_seed(0)
    ro = (torch.rand(3, 4096, generator=g) * 8.0 - 4.0) + torch.tensor([0.0, 0.5, 6.0])[:, None]
    rd = torch.randn(3, 4096, generator=g)
    rd = rd / torch.linalg.vector_norm(rd, dim=0, keepdim=True)
    rays = torch.cat([cam_rays, torch.cat([ro, rd]).to(dev)], dim=1).contiguous()
    n = rays.shape[1]
    live = (torch.rand(n, generator=g) > 0.3).float().to(dev)
    out = {"phase": "trace", "scene": "two", "rays": n, "cases": []}
    worst = 0.0
    for name, lv in (("all", None), ("live", live)):
        got = tr.trace_cuda(kt, rays, lv)
        ref = tr.trace_plain(kt, rays, lv)
        torch.cuda.synchronize()
        case = {"case": name, **compare_trace(got, ref, lv)}
        worst = max(worst, case["max_abs_err"])
        out["cases"].append(case)
    # the SceneHit entry: return_slots keeps the raw slot, else tri_gid[slot]
    o3, d3 = rays[0:3], rays[3:6]
    h_slot = tr.trace(scene, o3, d3, return_slots=True)
    h_tri = tr.trace(scene, o3, d3)
    slots = h_slot.tri.long()
    out["return_slots_ok"] = bool(
        torch.equal(kt.tri_gid[slots].int(), h_tri.tri)
        and torch.equal(h_slot.t, h_tri.t)
    )
    out["ok"] = all(c["ok"] for c in out["cases"]) and out["return_slots_ok"]
    results["trace_err"] = worst
    emit(out)
    if not out["ok"]:
        raise SystemExit("trace phase failed")


def frame_args(scene, wh):
    """K2.2's arguments for a ``wh`` frame of the smoke camera, 2 bounces."""
    from clraytracer_tpu_torch.camera import Camera
    from clraytracer_tpu_torch.config import CameraConfig
    from clraytracer_tpu_torch.ops import render_fused as rf
    from clraytracer_tpu_torch.ops.trace import kernel_tables
    from clraytracer_tpu_torch.render import frame_inputs_from_camera

    w, h = wh
    cam = Camera.create(CameraConfig(position=CAMERA), w, h)
    cr = rf.camera_row(frame_inputs_from_camera(cam, SUN))
    trows = rf.tile_rows(w * h)
    rows_total = -(-h // trows) * -(-w // 128) * trows
    return kernel_tables(scene), rf.frame_tables(scene), cr, w, h, trows, rows_total, 2


def phase_fused(dev, results) -> None:
    import torch

    from clraytracer_tpu_torch.cli import build_scene
    from clraytracer_tpu_torch.ops import render_fused as rf

    worst = 0.0
    for spec in ("two", "sphere"):
        args = frame_args(build_scene(spec, device=dev), CHECK_WH)
        got = rf.render_cuda(*args)
        ref = rf.render_fused_plain(*args, dev)
        torch.cuda.synchronize()
        line = {"phase": "fused", "scene": spec, **compare_options(got, ref, 0, False)}
        worst = max(worst, line["max_abs_err_all"])
        emit(line)
        if not line["ok"]:
            raise SystemExit("fused phase failed")
    results["fused_err"] = worst


# ---------------------------------------------------------------------------
# K2.2's options: imported textures (atlas modes 1 and 2), sun shadows, GI
# ---------------------------------------------------------------------------


def option_scene(spec: str, tris: int = 4096, device=None):
    """Scenes of the option cells. ``atlas``: bench.py:78-92's sphere with
    its textures imported as images (the bakes of a 512x256 sky and a
    128/8 checker); ``atlas65``: the same with unused materials up to 65,
    past the 64 of atlas mode 1; ``sphere65``: ``sphere`` (procedural
    textures) with unused materials up to 65, past the 64 the fused
    kernel reads rows for; ``ground``: test_shadows.py:88-98's checkered
    ground quad under a red sphere. Others (``glass`` included):
    ``cli.build_scene``."""
    from clraytracer_tpu_torch import math3d
    from clraytracer_tpu_torch.bench import default_builder
    from clraytracer_tpu_torch.cli import build_scene
    from clraytracer_tpu_torch.scene import SceneBuilder
    from clraytracer_tpu_torch.scene import procedural_tex as ptex
    from clraytracer_tpu_torch.scene.procedural import quad, uv_sphere

    if spec in ("atlas", "atlas65", "sphere65"):
        # the bench's sphere (sphere65: its procedural textures)
        b = default_builder(tris, atlas=spec != "sphere65")
        if spec.endswith("65"):
            while len(b._materials) < 65:
                b.create_material(albedo=(0.5, 0.5, 0.5))
    elif spec == "ground":
        b = SceneBuilder()
        b.import_procedural(ptex.sky_gradient(32, 16))
        checker = b.import_procedural(ptex.checker(16, 4))
        ground = b.create_material(albedo=(0.85, 0.85, 0.85), albedo_tex=checker)
        red = b.create_material(albedo=(0.9, 0.2, 0.2))
        b.add_instance(b.add_mesh(quad(8.0, y=0.0), materials_start=ground))
        b.add_instance(b.add_mesh(uv_sphere(1.0, n_lat=8, n_lon=14), materials_start=red),
                       math3d.translation(0.0, 1.6, 0.0))
    else:
        return build_scene(spec, tris, device=device)
    return b.build(device=device)


def option_frame(spec: str, w: int, h: int, sun: float | None = None):
    """The camera and sun of a cell: test_shadows.py:38-44's view of the
    ground (sun overhead), else the smoke camera and SUN; ``sun`` sets
    another sun angle."""
    import math

    from clraytracer_tpu_torch.camera import Camera
    from clraytracer_tpu_torch.config import CameraConfig
    from clraytracer_tpu_torch.render import frame_inputs_from_camera

    if spec == "ground":
        cam = Camera.create(CameraConfig(position=(0.3, 4.0, 7.0), pitch_deg=-28.0), w, h)
        return frame_inputs_from_camera(cam, -math.pi / 2 if sun is None else sun)
    cam = Camera.create(CameraConfig(position=CAMERA), w, h)
    return frame_inputs_from_camera(cam, SUN if sun is None else sun)


def option_args(scene, frame, w, h, bounces=2):
    """K2.2's positional arguments for a w x h frame of ``frame``'s camera."""
    from clraytracer_tpu_torch.ops import render_fused as rf
    from clraytracer_tpu_torch.ops.trace import kernel_tables

    trows = rf.tile_rows(w * h)
    rows_total = -(-h // trows) * -(-w // 128) * trows
    return (kernel_tables(scene), rf.frame_tables(scene), rf.camera_row(frame), w, h,
            trows, rows_total, bounces)


def band_args(args, y0: int, rows: int):
    """K2.2's positional arguments ``args`` of a w x h frame, cut to the
    image rows y0 .. y0 + rows - 1 at full width: one strip of ``rows``
    rows per 128 columns, the camera row's row0 set to y0. Without GI a
    ray's planes depend only on its pixel, so these rays' planes are those
    of the same pixels in the whole frame's launch (``band_index``)."""
    from clraytracer_tpu_torch.ops.render_fused import CameraRow

    kt, ft, cr, w, h, _trows, _rows_total, bounces = args
    cr = CameraRow(cam=tuple(cr.cam[:35]) + (float(y0),), sun=cr.sun)
    return (kt, ft, cr, w, h, rows, rows * -(-w // 128), bounces)


def band_index(w: int, trows: int, y0: int, rows: int, device):
    """The ray indices, in a launch of width w and strip height trows, of
    the rays of ``band_args(..., y0, rows)`` in that band's order."""
    import torch

    tiles_x = -(-w // 128)
    r = torch.arange(rows * tiles_x, device=device)[:, None]
    lane = torch.arange(128, device=device)[None, :]
    py = y0 + r % rows
    whole = ((py // trows) * tiles_x + r // rows) * trows + py % trows
    return (whole * 128 + lane).reshape(-1)


def compare_options(got, ref, mode: int, gi: bool) -> dict:
    """K2.2's [9 + K*B, n] output against render_fused_plain's (atlas mode
    ``mode``, GI on or off): mode 1's pool-index planes exactly (as i32),
    every other plane within 1e-5 on all but FRAME_MISMATCH_MAX rays, with
    GI as without."""
    import torch

    from clraytracer_tpu_torch.ops.render_fused import deferred_planes

    k = deferred_planes(mode, gi)
    idx_rows = [9 + k * b for b in range((got.shape[0] - 9) // k)] if mode == 1 else []
    other = [r for r in range(got.shape[0]) if r not in idx_rows]
    diff = (got[other] - ref[other]).abs().amax(dim=0)
    bad = diff > 1e-5
    for r in idx_rows:
        bad |= got[r].view(torch.int32) != ref[r].view(torch.int32)
    n = diff.numel()
    allowed = FRAME_MISMATCH_MAX
    finite = bool(torch.isfinite(got[other]).all())
    good = diff[~bad]
    return {
        "rays": n, "rays_differing": int(bad.sum()), "allowed": allowed,
        "max_abs_err_within": float(good.max()) if good.numel() else 0.0,
        "max_abs_err_all": float(diff.max()), "finite": finite,
        "ok": int(bad.sum()) <= allowed and finite,
    }


def phase_options(dev, results) -> None:
    """Every option combination of K2.2 against render_fused_plain at
    CHECK_WH: atlas modes 0 (``sphere``), 1 (``atlas``) and 2
    (``atlas65``), each without and with shadows and GI, the shadowed
    ground, and the four jittered samples of a ``samples=4`` atlas GI
    frame (each with its own seed, as ``render_frame`` launches them)."""
    import torch

    from clraytracer_tpu_torch.ops import render_fused as rf
    from clraytracer_tpu_torch.render import _sample_offsets, jitter_projection

    w, h = CHECK_WH
    cases = []
    for spec in ("sphere", "atlas", "atlas65", "ground"):
        scene = option_scene(spec, device=dev)
        frame = option_frame(spec, w, h)
        mode = rf.atlas_mode_of(scene)
        combos = [(sh, gi) for sh in (False, True) for gi in (None, GI_SEED)]
        if spec == "ground":
            combos = [(True, None), (True, GI_SEED)]
        frames = [(frame, None, sh, gi) for sh, gi in combos]
        if spec == "atlas":
            for si, (jx, jy) in enumerate(_sample_offsets(4)):
                fj = frame._replace(inverse_projection=jitter_projection(
                    frame.inverse_projection, jx * 2.0 / w, jy * 2.0 / h))
                frames.append((fj, si, True, GI_SEED + si))
        for fr, si, sh, gi in frames:
            args = option_args(scene, fr, w, h)
            opts = dict(atlas_mode=mode, shadows=sh, gi_seed=gi)
            got = rf.render_cuda(*args, **opts)
            ref = rf.render_fused_plain(*args, dev, **opts)
            torch.cuda.synchronize()
            case = {"scene": spec, "atlas_mode": mode, "shadows": sh, "gi_seed": gi,
                    "sample": si, "variant": rf.variant(mode, sh, gi is not None),
                    **compare_options(got, ref, mode, gi is not None)}
            cases.append(case)
            emit({"phase": "options", **case})
            if not case["ok"]:
                raise SystemExit("options phase failed")
            if si is not None:
                continue
            # ray mode: on the camera's tiled rays it gives camera mode's
            # planes bit for bit; on rays with their own origins it agrees
            # with the plain version on the same rays
            cam_bits = got.view(torch.int32)
            rays, _cam = camera_rays(w, h, dev, fr)
            same = rf.render_cuda(*args, rays=rays, **opts)
            jr = jittered_rays(rays, len(cases))
            got = rf.render_cuda(*args, rays=jr, **opts)
            ref = rf.render_fused_plain(*args, dev, rays=jr, **opts)
            torch.cuda.synchronize()
            case = {"scene": spec, "atlas_mode": mode, "shadows": sh, "gi_seed": gi,
                    "sample": None, "variant": rf.variant(mode, sh, gi is not None, True),
                    "rays": "camera rays, each origin moved and direction turned (seeded)",
                    "equals_camera_mode": torch.equal(same.view(torch.int32), cam_bits),
                    **compare_options(got, ref, mode, gi is not None)}
            case["ok"] = case["ok"] and case["equals_camera_mode"]
            cases.append(case)
            emit({"phase": "options", **case})
            if not case["ok"]:
                raise SystemExit("options phase failed (ray mode)")
    for case in carry_cases(dev):
        cases.append(case)
        emit({"phase": "options", **case})
        if not case["ok"]:
            raise SystemExit("options phase failed (carry)")
    results["options"] = cases


def carry_cases(dev, wh=CHECK_WH) -> list:
    """The carry instantiations against their plain versions at ``wh``:
    the carry-out launch (bounce 0, camera mode, 19 planes) without and
    with shadows, and the carry-in launch (ray mode from global bounce 1)
    on the rows ``rebin_rows`` re-bins from the plain carry-out's output,
    so that both versions resume from the same state; the carry-in also
    over 2 remaining bounces (the atmospheric chain from bounce 1 on)."""
    import torch

    from clraytracer_tpu_torch.ops import render_fused as rf

    w, h = wh
    cases = []
    for spec, sh, rest in (("sphere", False, 2), ("ground", False, 1), ("ground", True, 1)):
        scene = option_scene(spec, device=dev)
        args = option_args(scene, option_frame(spec, w, h), w, h, bounces=1)
        got = rf.render_cuda(*args, carry_out=True, shadows=sh)
        ref = rf.render_fused_plain(*args, dev, carry_out=True, shadows=sh)
        torch.cuda.synchronize()
        cases.append({"scene": spec, "atlas_mode": 0, "shadows": sh, "gi_seed": None,
                      "sample": None, "variant": rf.variant(0, sh, False, carry="out"),
                      **compare_options(got, ref, 0, False)})
        rays, carry, _inv = rf.rebin_rows(ref, args[6])
        args2 = args[:7] + (rest,)
        kw = dict(rays=rays, carry=carry, start_bounce=1, shadows=sh)
        got = rf.render_cuda(*args2, **kw)
        ref = rf.render_fused_plain(*args2, dev, **kw)
        torch.cuda.synchronize()
        cases.append({"scene": spec, "atlas_mode": 0, "shadows": sh, "gi_seed": None,
                      "sample": None, "variant": rf.variant(0, False, False, True, "in"),
                      "bounces": rest, "live_rays": int((carry[12] > 0.5).sum()),
                      **compare_options(got, ref, 0, False)})
    return cases


def jittered_rays(rays, seed: int):
    """Camera rays [6, n] with each origin moved by up to 0.5 along each
    axis and each direction turned by a seeded normal of scale 0.05 and
    renormalised: every lane of a warp has a ray of its own, which ray mode
    allows and camera mode never gives."""
    import torch

    g = torch.Generator(device="cpu").manual_seed(seed)
    n = rays.shape[1]
    do = (torch.rand(3, n, generator=g) - 0.5).to(rays.device)
    d = rays[3:6] + (0.05 * torch.randn(3, n, generator=g)).to(rays.device)
    d = d / torch.linalg.vector_norm(d, dim=0, keepdim=True)
    return torch.cat([rays[0:3] + do, d]).contiguous()


def shadow_rays(kt, rays, rec, sun):
    """The bounce-0 shadow rays [6, n] of camera rays [6, n] whose hit
    record (K2.1's [11, n] layout) is ``rec``, from render.cu's origin
    ``(mo + md t) + n 0.01`` toward the sun (sin, cos), and the mask of the
    rays that hit."""
    import torch

    from clraytracer_tpu_torch.ops import trace as tr

    t = rec[0]
    hit = t < tr.BIG
    m = kt.inst[rec[4].view(torch.int32).long()].T
    o, d = rays[0:3], rays[3:6]
    nw = [rec[5] * m[c] + rec[6] * m[4 + c] + rec[7] * m[8 + c] for c in range(3)]
    sn = torch.sqrt(nw[0] * nw[0] + nw[1] * nw[1] + nw[2] * nw[2])
    so = [((o[0] * m[c] + o[1] * m[4 + c] + o[2] * m[8 + c] + m[12 + c])
           + (d[0] * m[c] + d[1] * m[4 + c] + d[2] * m[8 + c]) * t) + (nw[c] / sn) * 0.01
          for c in range(3)]
    zero = torch.zeros_like(t)
    return torch.stack(so + [zero, zero - sun[0], zero - sun[1]]).contiguous(), hit


def shadow_masks(kt, rays, sun):
    """The masks [n] of bounce-0 hits whose shadow ray toward the sun is
    occluded and of the hits, of camera rays [6, n], by K2.1 launches
    (``shadow_rays``)."""
    from clraytracer_tpu_torch.ops import trace as tr

    srays, hit = shadow_rays(kt, rays, tr.trace_cuda(kt, rays), sun)
    occ = tr.trace_cuda(kt, srays, hit.float())[0] < tr.BIG
    return hit & occ, hit


def shadowed_hits(kt, rays, sun) -> tuple[int, int]:
    """(bounce-0 hits in shadow, hits) of camera rays [6, n]
    (``shadow_masks``)."""
    in_shadow, hit = shadow_masks(kt, rays, sun)
    return int(in_shadow.sum()), int(hit.sum())


def band_start(mask, w: int, h: int, trows: int, rows: int) -> int:
    """The first image row of a band of ``rows`` rows centred on the median
    image row of the rays in ``mask`` (a launch's strip order, width w,
    strip height trows), kept inside the frame; the middle of the frame
    when the mask is empty."""
    import torch

    r = torch.nonzero(mask)[:, 0] // 128
    if r.numel() == 0:
        return (h - rows) // 2
    py = (r // trows // -(-w // 128)) * trows + r % trows
    mid = int(py.float().median())
    return max(0, min(h - rows, mid - rows // 2))


def variant_bound(kt, ft, counts, clusters, slots, n, bounces, mode, gi, key=None,
                  shadow_counts=None, rays=False, carry=None) -> dict:
    """A K2.2 instantiation's bound: the bytes the scene's data needs
    (``walk_bytes``) plus its 9 + K*B output planes (and in ray mode,
    ``rays``, its 6 input planes; ``carry`` "out": 10 more output planes,
    "in": 13 more input planes), and the operations of this run's counts
    (the shadow walk's included) with the shading of its atlas mode and GI
    per shaded hit and, in camera mode, the raygen per ray.
    ``shadow_counts``: the shadow walk's own counts, printed apart with the
    primary walks' (the rest). ``key`` (kernel, cell, triangles): where
    ``NEAREST_SHADOW_WALK_COUNTS`` holds it, the bound those counts give is
    printed beside this run's."""
    from clraytracer_tpu_torch.ops.render_fused import deferred_planes
    from clraytracer_tpu_torch.ops.trace import COUNTER_NAMES

    planes = 9 + deferred_planes(mode, gi) * bounces + (10 if carry == "out" else 0)
    inputs = (6 if rays else 0) + (13 if carry == "in" else 0)
    bytes_moved = walk_bytes(kt, clusters, slots, ft) + (planes + inputs) * n * 4
    t_bytes = bytes_moved / PEAK_BYTES * 1e3

    def operations(c):
        boxes, tris, xforms, hits = (float(x) for x in c[:4])
        return (boxes * BOX_OPS + tris * TRI_OPS + xforms * XFORM_OPS
                + hits * (INTERP_OPS + SHADE_OPS_BY_MODE[mode] + (GI_OPS if gi else 0))
                + (0 if rays else n * RAYGEN_OPS))

    ops = operations(counts)
    t_ops = ops / PEAK_F32 * 1e3
    out = {"counts": dict(zip(COUNTER_NAMES, counts)), "bytes": bytes_moved,
           "operations": ops, "output_planes": planes, "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    if shadow_counts is not None:
        out["shadow_walk_counts"] = dict(zip(COUNTER_NAMES, shadow_counts))
        out["primary_walk_counts"] = dict(
            zip(COUNTER_NAMES, (a - b for a, b in zip(counts, shadow_counts))))
    old = NEAREST_SHADOW_WALK_COUNTS.get(key)
    if old is not None:
        out["bound_ms_nearest_hit_shadow_counts"] = max(
            t_bytes, operations(old) / PEAK_F32 * 1e3)
    return out


def phase_option_cells(dev, results) -> None:
    """The option cells on the main path, each through render.render_frame
    at full width with the counts from zero: (h) ``atlas`` (mode 1), (i)
    ``atlas65`` (mode 2), (j) ``sphere`` with GI (bench.py's gi row), (k)
    the shadowed ground, sun overhead, (l) and (m) (a)'s and (c)'s spheres
    with shadows. Per cell: frame ms, K2.2 ms, the tail after it (texel
    gather / sky, post, untile), the host's time to issue a frame, K2.2's
    six counters, its bound, torch.profiler over 5 frames (device time by
    kernel, idle share), K2.2 against its plain version at the cell's own
    shapes (above PLAIN_FULL_MAX_TRIS triangles on a band of the same
    launch's rays, ``band_args``; the plain run also gives plain_ms) and on
    a CHECK_STRIP_WH strip. In the shadow
    cells also the bounce-0 hits in shadow, the shadow walk's six counts
    apart, and the same frame without shadows (its instantiation's ms and
    counts; in (k) the k0 split)."""
    import torch

    from clraytracer_tpu_torch.config import RenderConfig
    from clraytracer_tpu_torch.ops import render_fused as rf
    from clraytracer_tpu_torch.ops import trace as tr
    from clraytracer_tpu_torch.ops.post import post_process_tiled
    from clraytracer_tpu_torch.render import _untile, render_frame

    results["option_cells"] = []
    for tag, spec, tris, w, h, cfg_kw in OPTION_CELLS:
        t0 = time.perf_counter()
        scene = option_scene(spec, tris, device=dev)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        cfg = RenderConfig(width=w, height=h, **cfg_kw)
        frame = option_frame(spec, w, h)
        mode = rf.atlas_mode_of(scene)
        gi = cfg.enable_gi
        opts = dict(atlas_mode=mode, shadows=cfg.enable_shadows,
                    gi_seed=cfg.gi_seed if gi else None)
        name = rf.variant(mode, cfg.enable_shadows, gi)
        img = render_frame(scene, frame, cfg)  # first frame: tables upload
        torch.cuda.synchronize()
        # ---- the main path's own run: counts from zero
        reset_counts()
        ms, times = event_ms(lambda: render_frame(scene, frame, cfg), FRAMES, WARMUP)
        frames = FRAMES + WARMUP
        launches = {"K2.2": rf.render_cuda.launches, "K2.1": tr.trace_cuda.launches,
                    "K2.2_variants": dict(rf.render_cuda.variant_launches)}
        frame_host_ms = host_ms(lambda: render_frame(scene, frame, cfg), FRAMES)
        args = option_args(scene, frame, w, h, cfg.bounces)
        kt, ft, rows_total = args[0], args[1], args[6]
        n = rows_total * 128
        counters = torch.zeros(6, dtype=torch.int64, device=dev)
        shadow_cnt = (torch.zeros(6, dtype=torch.int64, device=dev)
                      if cfg.enable_shadows else None)
        out = rf.render_cuda(*args, counters, shadow_counters=shadow_cnt, **opts)
        kms, _ = event_ms(lambda: rf.render_cuda(*args, **opts), 10, 2)
        kdev = device_ms(lambda: rf.render_cuda(*args, **opts))
        # a shadow cell's frame without shadows (the instantiation of its
        # other options), timed beside it: the shadow walk's share
        unshadowed = None
        if cfg.enable_shadows:
            u_opts = dict(opts, shadows=False)
            u_cnt = torch.zeros(6, dtype=torch.int64, device=dev)
            rf.render_cuda(*args, u_cnt, **u_opts)
            unshadowed = {
                "variant": rf.variant(mode, False, gi),
                "kernel_ms": event_ms(lambda: rf.render_cuda(*args, **u_opts), 10, 2)[0],
                "kernel_device_ms": device_ms(lambda: rf.render_cuda(*args, **u_opts)),
                "counts": u_cnt.cpu().tolist(),
            }
        cnt = counters.cpu().tolist()
        rays, _cam = camera_rays(w, h, dev, frame)
        clusters, slots = winners(tr.trace_cuda(kt, rays))
        kb = variant_bound(
            kt, ft, cnt, clusters, slots, n, cfg.bounces, mode, gi,
            key=("K2.2", tag, int(scene.tris.count)),
            shadow_counts=None if shadow_cnt is None else shadow_cnt.cpu().tolist())
        shadow, in_shadow = None, None
        if cfg.enable_shadows:
            in_shadow, hit0 = shadow_masks(kt, rays, args[2].sun)
            shadow = {"bounce0_hits": int(hit0.sum()),
                      "bounce0_hits_in_shadow": int(in_shadow.sum()),
                      "walk_counts": kb["shadow_walk_counts"],
                      "without_shadows": unshadowed}
        del rays
        # the plain version on the same inputs: timed once, and held against
        # the output of the launch above, at the cell's own shapes (above
        # PLAIN_FULL_MAX_TRIS triangles on a band of that launch's rays,
        # through the middle of its bounce-0 hits in shadow)
        pargs, p_out, p_frame, band = args, out, f"{w}x{h}", None
        if int(scene.tris.count) > PLAIN_FULL_MAX_TRIS:
            if gi:
                raise SystemExit(f"option cell {tag}: a band check needs a frame without GI")
            y0 = (band_start(in_shadow, w, h, args[5], CHECK_BAND_ROWS)
                  if in_shadow is not None else (h - CHECK_BAND_ROWS) // 2)
            pargs = band_args(args, y0, CHECK_BAND_ROWS)
            band = band_index(w, args[5], y0, CHECK_BAND_ROWS, dev)
            p_out = out[:, band]
            p_frame = (f"{w}x{CHECK_BAND_ROWS} band (rows {y0}-{y0 + CHECK_BAND_ROWS - 1})"
                       f" of {w}x{h}")
            if shadow is not None:  # the checked band holds hits in shadow too
                shadow["band_bounce0_hits"] = int(hit0[band].sum())
                shadow["band_bounce0_hits_in_shadow"] = int(in_shadow[band].sum())
        keep = []
        plain_ms, _ = event_ms(
            lambda: keep.append(rf.render_fused_plain(*pargs, dev, **opts)), 1, 0)
        full = compare_options(p_out, keep.pop(), mode, gi)
        del p_out
        out3 = out.reshape(-1, rows_total, 128)
        trows = args[5]
        layout = ("strip", trows, -(-w // 128), -(-h // trows))
        fin = lambda: rf._finish_frame(scene, out3, mode, gi)
        res = fin()
        post = lambda: post_process_tiled(res, w, h, layout)
        pp = post()
        tail = {
            "finish_ms": event_ms(fin, 10, 2)[0],
            "post_ms": event_ms(post, 10, 2)[0],
            "untile_ms": event_ms(
                lambda: _untile(pp, layout, h, w).permute(1, 2, 0).contiguous(), 10, 2
            )[0],
        }
        del out, out3, res, pp
        prof = device_profile(lambda: render_frame(scene, frame, cfg), 5, ms)
        img = render_frame(scene, frame, cfg)
        finite = bool(torch.isfinite(img).all())
        sargs = option_args(scene, frame, *CHECK_STRIP_WH, cfg.bounces)
        check = compare_options(rf.render_cuda(*sargs, **opts),
                                rf.render_fused_plain(*sargs, dev, **opts), mode, gi)
        torch.cuda.synchronize()
        line = {
            "phase": "option_cells", "config": tag, "scene": spec, "variant": name,
            "atlas_mode": mode, "options": cfg_kw, "materials": int(scene.materials.count),
            "triangles": int(scene.tris.count), "width": w, "height": h,
            "bounces": cfg.bounces, "host_build_s": build_s,
            "frame_ms": ms, "frame_ms_min": times[0], "frame_ms_max": times[-1],
            "frame_host_ms": frame_host_ms,
            "mrays_per_s": w * h * cfg.bounces / (ms * 1e-3) / 1e6,
            "kernel_ms": kms, "kernel_device_ms": kdev, "plain_ms": plain_ms,
            "kernel_bound_ms": kb["bound_ms"],
            "kernel_bound_by": kb["bound_by"], "kernel_bound": kb,
            "winning_clusters": clusters, "winning_slots": slots, "tail": tail,
            "launches": launches, "frames": frames,
            "box_tests": cnt[0], "tri_tests": cnt[1], "ray_transforms": cnt[2],
            "shaded_hits": cnt[3], "node_steps": cnt[4], "staged_clusters": cnt[5],
            "rays_traced": n, "shadow": shadow, "finite": finite,
            "mean": float(img.mean()), "check": {"frame": list(CHECK_STRIP_WH), **check},
            "check_full": {"frame": p_frame, **full}, "plain_frame": p_frame,
            "profile": prof,
        }
        line["ok"] = (
            finite and check["ok"] and full["ok"] and launches["K2.2"] == frames
            and launches["K2.2_variants"] == {name: frames} and launches["K2.1"] == 0
            and (shadow is None or shadow["bounce0_hits_in_shadow"] > 0)
            and (shadow is None or band is None or shadow["band_bounce0_hits_in_shadow"] > 0)
        )
        results["option_cells"].append(line)
        results["fused_err"] = max(results["fused_err"], check["max_abs_err_within"],
                                   full["max_abs_err_within"])
        emit(line)
        if not line["ok"]:
            raise SystemExit(f"option cell {tag} failed")


def phase_twophase_cells(dev, results) -> None:
    """The two-phase path on the main path, (n)-(q), each through
    render.render_frame at 1920x1080 with the counts from zero: (n)
    ``glass`` with refraction, (o) (k)'s shadowed ground with float colours
    (shadow rays through K2.1 with the live mask), (p) (a)'s sphere with
    material shading and GI, (q) ``sphere65`` (65 materials, every texture
    procedural). Per cell: frame ms, the host's time to issue a frame, K2.1
    and K2.2 launches per frame (K2.2 none), a finite image, and every K2.1
    launch of one frame (its bounces and shadow rays, recorded with their
    live masks) against trace_plain on the same inputs, each timed per
    call and on the card beside its plain version, with its counters and
    bound; torch.profiler over 5 frames (device time by kernel, idle
    share)."""
    import torch

    from clraytracer_tpu_torch.config import RenderConfig
    from clraytracer_tpu_torch.ops import render_fused as rf
    from clraytracer_tpu_torch.ops import trace as tr
    from clraytracer_tpu_torch.render import render_frame

    results["twophase_cells"] = []
    for tag, spec, tris, w, h, cfg_kw, per_frame in TWO_PHASE_CELLS:
        t0 = time.perf_counter()
        scene = option_scene(spec, tris, device=dev)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        cfg = RenderConfig(width=w, height=h, **cfg_kw)
        frame = option_frame(spec, w, h)
        render_frame(scene, frame, cfg)  # first frame: tables upload
        torch.cuda.synchronize()
        # ---- the main path's own run: counts from zero
        reset_counts()
        ms, times = event_ms(lambda: render_frame(scene, frame, cfg), FRAMES, WARMUP)
        frames = FRAMES + WARMUP
        counts = read_counts()
        frame_host_ms = host_ms(lambda: render_frame(scene, frame, cfg), FRAMES)
        # ---- every K2.1 launch of one frame, with its inputs
        rec = []
        real = tr.trace_cuda

        def recorder(kt, rays, live=None, counters=None):
            out = real(kt, rays, live, counters)
            rec.append((kt, rays, live, out))
            return out

        # the wrapper counts on the module's ``trace_cuda``, the recorder
        # while it stands in
        recorder.launches = 0
        tr.trace_cuda = recorder
        try:
            img = render_frame(scene, frame, cfg)
            torch.cuda.synchronize()
        finally:
            tr.trace_cuda = real
        finite = bool(torch.isfinite(img).all())
        checks = []
        for k, (kt, rays, live, out) in enumerate(rec):
            keep = []
            plain_ms, _ = event_ms(lambda: keep.append(tr.trace_plain(kt, rays, live)), 1, 0)
            case = compare_trace(out, keep.pop(), live)
            cnt = torch.zeros(6, dtype=torch.int64, device=dev)
            real(kt, rays, live, cnt)
            n = rays.shape[1]
            clusters, slots = winners(out)
            kb = walk_bound(("K2.1", tag, int(scene.tris.count)),
                            (6 + 11 + (1 if live is not None else 0)) * n * 4
                            + walk_bytes(kt, clusters, slots), cnt.cpu().tolist())
            case.update({
                "launch": k, "rays": n,
                "live_rays": n if live is None else int((live != 0).sum()),
                "hits": int((out[0].abs() < tr.BIG).sum()),
                "ms": event_ms(lambda: real(kt, rays, live), 10, 2)[0],
                "device_ms": device_ms(lambda: real(kt, rays, live)),
                "plain_ms": plain_ms, "bound_ms": kb["bound_ms"],
                "bound_by": kb["bound_by"], "bound": kb,
            })
            checks.append(case)
        del rec, out, rays, live
        prof = device_profile(lambda: render_frame(scene, frame, cfg), 5, ms)
        line = {
            "phase": "twophase_cells", "config": tag, "scene": spec, "options": cfg_kw,
            "triangles": int(scene.tris.count), "materials": int(scene.materials.count),
            "width": w, "height": h, "bounces": cfg.bounces, "host_build_s": build_s,
            "fused_path_available": rf.fused_path_available(
                scene, cfg.reference_parity_shading, cfg.integer_colors),
            "frame_ms": ms, "frame_ms_min": times[0], "frame_ms_max": times[-1],
            "frame_host_ms": frame_host_ms,
            "mrays_per_s": w * h * cfg.bounces / (ms * 1e-3) / 1e6,
            "launches": counts, "frames": frames,
            "k21_launches_per_frame": counts["K2.1"] / frames,
            "k22_launches_per_frame": counts["K2.2"] / frames,
            "k21_ms_per_frame": sum(c["ms"] for c in checks),
            "k21_device_ms_per_frame": sum(c["device_ms"] for c in checks),
            "k21_checks": checks, "finite": finite, "mean": float(img.mean()),
            "profile": prof,
        }
        line["ok"] = (
            finite and len(checks) == per_frame and all(c["ok"] for c in checks)
            and counts == {"K2.1": per_frame * frames, "K2.2": 0, "K2.3": 0, "K2.4": 0}
            and (tag != "q" or not line["fused_path_available"])
            and (tag != "o" or checks[1]["live_rays"] < checks[1]["rays"])
        )
        results["twophase_cells"].append(line)
        results["trace_err"] = max(results["trace_err"], *(c["max_abs_err"] for c in checks))
        emit(line)
        if not line["ok"]:
            raise SystemExit(f"two-phase cell {tag} failed")


def phase_ray_cell(dev, results) -> None:
    """(r) ``render.trace_planar`` with K2.1's tracer and integer colours on
    (a)'s scene and the camera's [3, H, W] rays at 1920x1080: one launch of
    K2.2 in ray mode per call and no K2.1 (counts from zero), call ms and
    the host's time to issue a call, a finite image; the launch, recorded
    with its rays, against render_fused_plain on them (the plain run gives
    plain_ms), timed per call and on the card, its counters and bound; the
    same rays with GI (ray i's seed i*9999 wraps at 32 bits past 429,540)
    against the plain version; and ray mode on the camera's 1920x1080
    tiled rays, bit for bit equal to camera mode, both timed in turns."""
    import torch

    from clraytracer_tpu_torch import render
    from clraytracer_tpu_torch.camera import ray_directions_planar
    from clraytracer_tpu_torch.cli import build_scene
    from clraytracer_tpu_torch.ops import render_fused as rf
    from clraytracer_tpu_torch.ops import trace as tr

    tag, spec, tris, w, h = RAY_CELL
    scene = build_scene(spec, tris, device=dev)
    frame = diff_frame(w, h, dev)
    dirs = ray_directions_planar(frame.inverse_view, frame.inverse_projection, w, h)
    origin = frame.camera_position[:, None, None].expand(dirs.shape)
    call = lambda: render.trace_planar(scene, origin, dirs, frame.sun_angle, 2, tr.trace,
                                       True, True)
    call()  # first call: tables upload
    torch.cuda.synchronize()
    # ---- the main path's own run: counts from zero
    reset_counts()
    ms, times = event_ms(call, FRAMES, WARMUP)
    calls = FRAMES + WARMUP
    counts = read_counts()
    variants = dict(rf.render_cuda.variant_launches)
    call_host_ms = host_ms(call, FRAMES)
    # ---- the launch of one call, with its rays
    rec = []
    real = rf.render_cuda

    def recorder(*args, **kw):
        out = real(*args, **kw)
        rec.append((args, kw, out))
        return out

    # the wrapper counts on the module's ``render_cuda``, the recorder
    # while it stands in
    recorder.launches, recorder.variant_launches = 0, {}
    rf.render_cuda = recorder
    try:
        img = call()
        torch.cuda.synchronize()
    finally:
        rf.render_cuda = real
    finite = bool(torch.isfinite(img).all()) and tuple(img.shape) == (3, h, w)
    (args, kw, out), = rec
    kt, ft = args[0], args[1]
    rays, mode = kw["rays"], kw["atlas_mode"]
    n = rays.shape[1]
    keep = []
    plain_ms, _ = event_ms(lambda: keep.append(rf.render_fused_plain(*args, dev, **kw)), 1, 0)
    check = compare_options(out, keep.pop(), mode, False)
    del out, rec
    counters = torch.zeros(6, dtype=torch.int64, device=dev)
    real(*args, counters, **kw)
    kms, _ = event_ms(lambda: real(*args, **kw), 10, 2)
    kdev = device_ms(lambda: real(*args, **kw))
    cnt = counters.cpu().tolist()
    clusters, slots = winners(tr.trace_cuda(kt, rays))
    kb = variant_bound(kt, ft, cnt, clusters, slots, n, 2, mode, False, rays=True)
    gi_kw = dict(kw, gi_seed=GI_SEED)
    gi_check = compare_options(real(*args, **gi_kw), rf.render_fused_plain(*args, dev, **gi_kw),
                               mode, True)
    # the same scene's camera rays in screen-tile order: ray mode against
    # camera mode on the same work, bit for bit and timed in turns
    targs = option_args(scene, option_frame(spec, w, h), w, h)
    trays, _cam = camera_rays(w, h, dev)
    cam_run = lambda: real(*targs, atlas_mode=mode)
    ray_run = lambda: real(*targs, atlas_mode=mode, rays=trays)
    tiled = {"equal": torch.equal(ray_run().view(torch.int32), cam_run().view(torch.int32))}
    for name, fn in (("camera_mode", cam_run), ("ray_mode", ray_run),
                     ("ray_mode_again", ray_run), ("camera_mode_again", cam_run)):
        tiled[f"{name}_ms"] = event_ms(fn, 10, 2)[0]
        tiled[f"{name}_device_ms"] = device_ms(fn)
    del trays
    torch.cuda.synchronize()
    line = {
        "phase": "ray_cell", "config": tag, "entry": "render.trace_planar",
        "scene": spec, "triangles": int(scene.tris.count), "width": w, "height": h,
        "bounces": 2, "rays": n, "call_ms": ms, "call_ms_min": times[0],
        "call_ms_max": times[-1], "call_host_ms": call_host_ms,
        "mrays_per_s": w * h * 2 / (ms * 1e-3) / 1e6,
        "launches": counts, "calls": calls, "k22_variant_launches": variants,
        "kernel_ms": kms, "kernel_device_ms": kdev, "plain_ms": plain_ms,
        "kernel_bound_ms": kb["bound_ms"], "kernel_bound_by": kb["bound_by"],
        "kernel_bound": kb, "winning_clusters": clusters, "winning_slots": slots,
        "check": check, "check_gi": {"gi_seed": GI_SEED, **gi_check},
        "tiled_rays": tiled, "finite": finite, "mean": float(img.mean()),
    }
    line["ok"] = (
        finite and check["ok"] and gi_check["ok"] and tiled["equal"]
        and counts == {"K2.1": 0, "K2.2": calls, "K2.3": 0, "K2.4": 0}
        and variants == {rf.variant(mode, False, False, True): calls}
    )
    results["ray_cell"] = line
    emit(line)
    if not line["ok"]:
        raise SystemExit("ray cell r failed")


def split_plain_check(args, first, second, rays, carry, sh, tris: int, dev) -> dict:
    """The two launches of a split frame against their plain versions on
    the same inputs, each timed once: the carry-out launch (``args``, one
    bounce) and the carry-in launch on its re-binned rays and carry. Above
    PLAIN_FULL_MAX_TRIS triangles on a band of CHECK_BAND_ROWS image rows
    of the carry-out launch (``band_args``) and on as many rays, the first
    rows of the carry-in launch, whose live rows the re-bin put first (a
    ray-mode ray's planes depend on its inputs alone)."""
    from clraytracer_tpu_torch.ops import render_fused as rf

    _kt, _ft, _cr, w, h, trows, rows_total, _b = args
    pargs, p_first, what = args, first, f"{w}x{h}"
    rows2 = rows_total
    if tris > PLAIN_FULL_MAX_TRIS:
        y0 = (h - CHECK_BAND_ROWS) // 2
        pargs = band_args(args, y0, CHECK_BAND_ROWS)
        p_first = first[:, band_index(w, trows, y0, CHECK_BAND_ROWS, dev)]
        rows2 = min(rows_total, CHECK_BAND_ROWS * -(-w // 128))
        what = (f"{w}x{CHECK_BAND_ROWS} band (rows {y0}-{y0 + CHECK_BAND_ROWS - 1}); "
                f"carry-in on its first {rows2} rows")
    keep = []
    out_ms, _ = event_ms(lambda: keep.append(
        rf.render_fused_plain(*pargs, dev, carry_out=True, shadows=sh)), 1, 0)
    out_check = compare_options(p_first, keep.pop(), 0, False)
    n2 = rows2 * 128
    r2, c2 = rays[:, :n2].contiguous(), carry[:, :n2].contiguous()
    args2 = args[:6] + (rows2, 1)
    in_ms, _ = event_ms(lambda: keep.append(rf.render_fused_plain(
        *args2, dev, rays=r2, carry=c2, start_bounce=1)), 1, 0)
    in_check = compare_options(second[:, :n2], keep.pop(), 0, False)
    return {"checked": what, "carry_out": {"plain_ms": out_ms, **out_check},
            "carry_in": {"plain_ms": in_ms, "rays": n2, **in_check},
            "ok": out_check["ok"] and in_check["ok"]}


def phase_split_cell(dev, results) -> None:
    """(s) ``render_fused_camera(split_rebin=True)`` at 1920x1080, 2
    bounces, on SPLIT_CELLS: per scene the split frame's main-path run
    (counts from zero: per frame one carry-out and one carry-in launch, no
    K2.1), the split and the unsplit frame timed in turns (unsplit, split,
    split, unsplit), each launch's call ms and device ms, the re-bin glue's
    ms (``rebin_rows`` and the inverse row gather; in the first cell
    torch.profiler over 5 re-bins), the second launch's six
    counters beside the unsplit frame's bounce-1 share (its counts less
    its bounce 0 alone), the rays of the split frame that differ from the
    unsplit frame's (at most FRAME_MISMATCH_MAX over 1e-5), a finite image,
    both launches against their plain versions (``split_plain_check``) and
    their bounds."""
    import torch

    from clraytracer_tpu_torch.ops import render_fused as rf
    from clraytracer_tpu_torch.ops import trace as tr
    from clraytracer_tpu_torch.ops.trace import COUNTER_NAMES

    results["split_cells"] = []
    for tag, spec, tris, w, h, sh in SPLIT_CELLS:
        scene = option_scene(spec, tris, device=dev)
        frame = option_frame(spec, w, h)
        frame_fn = lambda split: (lambda: rf.render_fused_camera(
            scene, frame, w, h, 2, enable_shadows=sh, split_rebin=split)[0])
        split, unsplit = frame_fn(True), frame_fn(False)
        img = split()  # first frame: tables upload
        unsplit()
        torch.cuda.synchronize()
        # ---- the main path's own run: counts from zero
        reset_counts()
        ms, times = event_ms(split, FRAMES, WARMUP)
        frames = FRAMES + WARMUP
        counts = read_counts()
        variants = dict(rf.render_cuda.variant_launches)
        turns = {}
        for k, (name, fn) in enumerate((("unsplit", unsplit), ("split", split),
                                        ("split", split), ("unsplit", unsplit))):
            turns[f"{k}_{name}_ms"] = event_ms(fn, 10, 2)[0]
        # ---- the two launches, the glue between them, their counts
        args1 = option_args(scene, frame, w, h, bounces=1)
        rows_total = args1[6]
        n = rows_total * 128
        c_first = torch.zeros(6, dtype=torch.int64, device=dev)
        c_second = torch.zeros(6, dtype=torch.int64, device=dev)
        first = rf.render_cuda(*args1, c_first, carry_out=True, shadows=sh)
        rays, carry, inv = rf.rebin_rows(first, rows_total)
        kw2 = dict(rays=rays, carry=carry, start_bounce=1)
        second = rf.render_cuda(*args1, c_second, **kw2)
        launch1 = lambda: rf.render_cuda(*args1, carry_out=True, shadows=sh)
        launch2 = lambda: rf.render_cuda(*args1, **kw2)
        put_back = lambda: second.reshape(9, rows_total, 128)[:, inv]
        launches = {
            "carry_out_ms": event_ms(launch1, 10, 2)[0],
            "carry_out_device_ms": device_ms(launch1),
            "carry_in_ms": event_ms(launch2, 10, 2)[0],
            "carry_in_device_ms": device_ms(launch2),
            "glue_rebin_ms": event_ms(lambda: rf.rebin_rows(first, rows_total), 10, 2)[0],
            "glue_put_back_ms": event_ms(put_back, 10, 2)[0],
        }
        launches["glue_ms"] = launches["glue_rebin_ms"] + launches["glue_put_back_ms"]
        glue_profile = None
        if tag == SPLIT_CELLS[0][0]:  # where the glue's time goes, once
            glue_profile = device_profile(lambda: rf.rebin_rows(first, rows_total), 5,
                                          launches["glue_rebin_ms"])
        # ---- the unsplit launch and its bounce 0 alone: the bounce-1 share
        args2 = args1[:7] + (2,)
        c_whole = torch.zeros(6, dtype=torch.int64, device=dev)
        c_b0 = torch.zeros(6, dtype=torch.int64, device=dev)
        whole = rf.render_cuda(*args2, c_whole, shadows=sh)
        rf.render_cuda(*args1, c_b0, shadows=sh)
        launches["unsplit_ms"] = event_ms(lambda: rf.render_cuda(*args2, shadows=sh), 10, 2)[0]
        launches["unsplit_device_ms"] = device_ms(lambda: rf.render_cuda(*args2, shadows=sh))
        split9 = put_back().reshape(9, -1)
        vs_unsplit = compare_options(split9, whole, 0, False)
        cw, cb0 = c_whole.cpu().tolist(), c_b0.cpu().tolist()
        cnt1, cnt2 = c_first.cpu().tolist(), c_second.cpu().tolist()
        counters = {
            "carry_out": dict(zip(COUNTER_NAMES, cnt1)),
            "carry_in": dict(zip(COUNTER_NAMES, cnt2)),
            "unsplit": dict(zip(COUNTER_NAMES, cw)),
            "unsplit_bounce0": dict(zip(COUNTER_NAMES, cb0)),
            "unsplit_bounce1_share": dict(zip(COUNTER_NAMES, (a - b for a, b in zip(cw, cb0)))),
        }
        del whole, split9
        # ---- bounds: bounce 0's winners for the carry-out launch, those of
        # the carried live rays for the carry-in launch
        kt, ft = args1[0], args1[1]
        cam_rays, _cam = camera_rays(w, h, dev, frame)
        cl1, sl1 = winners(tr.trace_cuda(kt, cam_rays))
        del cam_rays
        cl2, sl2 = winners(tr.trace_cuda(kt, rays, (carry[12] > 0.5).float()))
        bound1 = variant_bound(kt, ft, cnt1, cl1, sl1, n, 1, 0, False, carry="out")
        bound2 = variant_bound(kt, ft, cnt2, cl2, sl2, n, 1, 0, False, rays=True, carry="in")
        plain = split_plain_check(args1, first, second, rays, carry, sh,
                                  int(scene.tris.count), dev)
        live_rays = int((carry[12] > 0.5).sum())
        live_rows = int((carry[12].reshape(rows_total, 128).amax(dim=1) > 0.5).sum())
        del first, second, rays, carry, inv
        finite = bool(torch.isfinite(img).all()) and tuple(img.shape) == (3, rows_total, 128)
        torch.cuda.synchronize()
        out_name = rf.variant(0, sh, False, carry="out")
        in_name = rf.variant(0, False, False, True, "in")
        line = {
            "phase": "split_cell", "config": f"s{tag}", "entry":
            "ops.render_fused.render_fused_camera(split_rebin=True)", "scene": spec,
            "triangles": int(scene.tris.count), "width": w, "height": h, "bounces": 2,
            "shadows": sh, "frame_ms": ms, "frame_ms_min": times[0], "frame_ms_max": times[-1],
            "turns": turns, "launches": counts, "frames": frames,
            "k22_variant_launches": variants, "kernels": launches,
            "glue_profile": glue_profile, "counters": counters,
            "live_rows_after_bounce0": live_rows, "live_rays_after_bounce0": live_rays,
            "vs_unsplit": vs_unsplit, "plain": plain,
            "carry_out_bound": bound1, "carry_in_bound": bound2,
            "carry_out_variant": out_name, "carry_in_variant": in_name,
            "finite": finite, "mean": float(img.mean()),
        }
        line["ok"] = (
            finite and vs_unsplit["ok"] and plain["ok"]
            and counts == {"K2.1": 0, "K2.2": 2 * frames, "K2.3": 0, "K2.4": 0}
            and variants == {out_name: frames, in_name: frames}
        )
        results["split_cells"].append(line)
        results["fused_err"] = max(results["fused_err"], plain["carry_out"]["max_abs_err_within"],
                                   plain["carry_in"]["max_abs_err_within"])
        emit(line)
        if not line["ok"]:
            raise SystemExit(f"split cell s{tag} failed")


def check_config(scene, w, h, dev) -> dict:
    """Both kernels against their plain versions on a main-path scene:
    K2.1 on CHECK_RAYS seeded camera rays of the w x h frame, K2.2 on a
    CHECK_STRIP_WH frame of the same camera. On (c) this is the one check
    of the traversal across several hyper groups."""
    import torch

    from clraytracer_tpu_torch.ops import render_fused as rf
    from clraytracer_tpu_torch.ops import trace as tr

    kt = tr.kernel_tables(scene)
    rays, _cam = camera_rays(w, h, dev)
    g = torch.Generator(device="cpu").manual_seed(1)
    pick = torch.randperm(rays.shape[1], generator=g)[:CHECK_RAYS].to(dev)
    sub = rays[:, pick].contiguous()
    k21 = compare_trace(tr.trace_cuda(kt, sub), tr.trace_plain(kt, sub))
    args = frame_args(scene, CHECK_STRIP_WH)
    k22 = compare_options(rf.render_cuda(*args), rf.render_fused_plain(*args, dev), 0, False)
    torch.cuda.synchronize()
    return {
        "hyper_groups": sum(-(-r[1] // 32) for r in kt.ranges_host),
        "K2.1": {"rays": CHECK_RAYS, **k21},
        "K2.2": {"frame": list(CHECK_STRIP_WH), **k22},
        "ok": k21["ok"] and k22["ok"],
    }


def phase_main(dev, results, tris_large: int) -> None:
    import torch

    from clraytracer_tpu_torch.cli import build_scene
    from clraytracer_tpu_torch.config import RenderConfig
    from clraytracer_tpu_torch.ops import render_fused as rf
    from clraytracer_tpu_torch.ops import trace as tr
    from clraytracer_tpu_torch.ops.post import post_process_tiled
    from clraytracer_tpu_torch.render import (
        _untile,
        frame_inputs_from_camera,
        render_frame,
    )
    from clraytracer_tpu_torch.camera import Camera
    from clraytracer_tpu_torch.config import CameraConfig

    results["main"] = []
    for tag, spec, tris, w, h in MAIN:
        tris = tris_large if tris is None else tris
        t0 = time.perf_counter()
        scene = build_scene(spec, tris, device=dev)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        note = None
        if tag == "c" and build_s > 180.0:
            note = f"host build {build_s:.1f} s > 180 s: cut to --tris 262144"
            t0 = time.perf_counter()
            scene = build_scene(spec, 262144, device=dev)
            torch.cuda.synchronize()
            build_s = time.perf_counter() - t0
            tris = 262144
        cfg = RenderConfig(width=w, height=h)
        cam = Camera.create(CameraConfig(position=CAMERA), w, h)
        frame = frame_inputs_from_camera(cam, SUN)
        img = render_frame(scene, frame, cfg)  # first frame: tables upload
        torch.cuda.synchronize()
        # ---- the main path's own run: counts from zero
        reset_counts()
        ms, times = event_ms(lambda: render_frame(scene, frame, cfg), FRAMES, WARMUP)
        frames = FRAMES + WARMUP
        launches = {"K2.2": rf.render_cuda.launches, "K2.1": tr.trace_cuda.launches,
                    "K2.2_variants": dict(rf.render_cuda.variant_launches)}
        frame_host_ms = host_ms(lambda: render_frame(scene, frame, cfg), FRAMES)
        # ---- test counts of one frame (a separate launch with counters)
        kt, ft = tr.kernel_tables(scene), rf.frame_tables(scene)
        cr = rf.camera_row(frame)
        trows = rf.tile_rows(w * h)
        rows_total = -(-h // trows) * -(-w // 128) * trows
        counters = torch.zeros(6, dtype=torch.int64, device=dev)
        out = rf.render_cuda(kt, ft, cr, w, h, trows, rows_total, cfg.bounces, counters)
        launch = lambda: rf.render_cuda(kt, ft, cr, w, h, trows, rows_total, cfg.bounces)
        kms, _ = event_ms(launch, 10, 2)
        kdev = device_ms(launch)
        cnt = counters.cpu().tolist()
        # ---- the walk split: K2.2's bounce 0 alone, and K2.1 on the frame's
        # camera rays, on the rays that hit alone and on those that miss
        # alone (each set compacted, so that a warp holds all hits or all
        # misses); the triangles these rays hit (bounce 0) enter K2.2's bound
        rays, _cam = camera_rays(w, h, dev)
        rec = tr.trace_cuda(kt, rays)
        hit = rec[0] < tr.BIG
        clusters, slots = winners(rec)
        split = {"k22_bounce0_ms": event_ms(
            lambda: rf.render_cuda(kt, ft, cr, w, h, trows, rows_total, 1), 10, 2)[0]}
        for name, rs in (("all", rays), ("hit", rays[:, hit].contiguous()),
                         ("miss", rays[:, ~hit].contiguous())):
            split[f"k21_{name}_rays"] = rs.shape[1]
            split[f"k21_{name}_ms"] = event_ms(lambda: tr.trace_cuda(kt, rs), 10, 2)[0]
        del rec, rays, rs
        kb = walk_bound(("K2.2", tag, int(scene.tris.count)),
                        walk_bytes(kt, clusters, slots, ft) + 9 * rows_total * 128 * 4,
                        cnt, rows_total * 128, shade=True)
        # ---- the frame's torch tail after the kernel, piece by piece
        out9 = out.reshape(9, rows_total, 128)
        layout = ("strip", trows, -(-w // 128), -(-h // trows))
        fin = lambda: rf._finish_frame(scene, out9)
        res = fin()
        post = lambda: post_process_tiled(res, w, h, layout)
        pp = post()
        tail = {
            "sky_ms": event_ms(fin, 10, 2)[0],
            "post_ms": event_ms(post, 10, 2)[0],
            "untile_ms": event_ms(
                lambda: _untile(pp, layout, h, w).permute(1, 2, 0).contiguous(), 10, 2
            )[0],
        }
        img = render_frame(scene, frame, cfg)
        finite = bool(torch.isfinite(img).all())
        check = check_config(scene, w, h, dev)
        results["trace_err"] = max(results["trace_err"], check["K2.1"]["max_abs_err"])
        results["fused_err"] = max(results["fused_err"], check["K2.2"]["max_abs_err_all"])
        line = {
            "phase": "main", "config": tag, "scene": spec,
            "triangles": int(scene.tris.count), "width": w, "height": h,
            "bounces": cfg.bounces, "host_build_s": build_s,
            "frame_ms": ms, "frame_ms_min": times[0], "frame_ms_max": times[-1],
            "frame_host_ms": frame_host_ms,
            "mrays_per_s": w * h * cfg.bounces / (ms * 1e-3) / 1e6,
            "kernel_ms": kms, "kernel_device_ms": kdev, "kernel_bound_ms": kb["bound_ms"],
            "kernel_bound_by": kb["bound_by"], "kernel_bound": kb,
            "winning_clusters": clusters, "winning_slots": slots, "split": split,
            "tail": tail,
            "k22_launches": launches["K2.2"], "frames": frames,
            "k22_launches_per_frame": launches["K2.2"] / frames,
            "k21_launches": launches["K2.1"],
            "box_tests": cnt[0], "tri_tests": cnt[1],
            "ray_transforms": cnt[2], "shaded_hits": cnt[3],
            "node_steps": cnt[4], "staged_clusters": cnt[5],
            "rays_traced": rows_total * 128,
            "finite": finite, "mean": float(img.mean()),
            "table_bytes": table_bytes(kt, ft),
            "check": check,
            "k22_variant_launches": launches["K2.2_variants"],
            "ok": finite and launches["K2.2"] == frames and check["ok"]
            and launches["K2.2_variants"] == {"default": frames},
        }
        if note:
            line["note"] = note
        results["main"].append(line)
        emit(line)
        if not line["ok"]:
            raise SystemExit(f"main path {tag} failed")
        del out

    # ---- (d) the hit-query entry ``ops.trace.trace`` (K2.1) on (a)'s scene
    # and 1920x1080 camera rays: its own path, its own counts from zero
    _tag, spec, tris, w, h = MAIN[0]
    scene = build_scene(spec, tris, device=dev)
    rays, _cam = camera_rays(w, h, dev)
    o3, d3 = rays[0:3], rays[3:6]
    hit = tr.trace(scene, o3, d3)  # first call: tables upload
    torch.cuda.synchronize()
    reset_counts()
    ms, times = event_ms(lambda: tr.trace(scene, o3, d3), FRAMES, WARMUP)
    calls = FRAMES + WARMUP
    launches = {"K2.1": tr.trace_cuda.launches, "K2.2": rf.render_cuda.launches}
    n = rays.shape[1]
    line = {
        "phase": "main", "config": "d", "entry": "ops.trace.trace",
        "scene": spec, "triangles": int(scene.tris.count), "rays": n,
        "call_ms": ms, "call_ms_min": times[0], "call_ms_max": times[-1],
        "mrays_per_s": n / (ms * 1e-3) / 1e6,
        "k21_launches": launches["K2.1"], "calls": calls,
        "k21_launches_per_call": launches["K2.1"] / calls,
        "k22_launches": launches["K2.2"],
        "hits": int(hit.hit.sum()), "finite": bool(torch.isfinite(hit.t).all()),
        "ok": launches["K2.1"] == calls and launches["K2.2"] == 0
        and int(hit.hit.sum()) > 0,
    }
    results["trace_path"] = line
    emit(line)
    if not line["ok"]:
        raise SystemExit("main path d failed")


# a torch.profiler session on the card's machine now and then records no
# device events (once the first glue profile of cell (s), code that had
# passed in the runs before): a session that holds none is taken again, up
# to this many sessions in all, before the run fails
PROFILE_ATTEMPTS = 3


def device_profile(fn, reps: int, step_ms: float) -> dict:
    """torch.profiler over ``reps`` calls of ``fn``: device time by kernel
    (the trace's ``kernel``/``gpu_mem*`` events) and the device's idle
    share, 1 - busy / step, where busy is the union of the device
    intervals per call and ``step_ms`` the call's CUDA-event median taken
    without the profiler (its host-side tracing slows the launches and so
    stretches the profiled span). ``profile_sessions``: the sessions it
    took (``PROFILE_ATTEMPTS``)."""
    import os
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    for sessions in range(1, PROFILE_ATTEMPTS + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        dev_ev = [
            e for e in events
            if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
        ]
        if dev_ev:
            break
    else:
        raise SystemExit(f"profile: {PROFILE_ATTEMPTS} traces hold no device events")
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in dev_ev)
    busy, end = 0.0, spans[0][0]  # union of the device intervals, in us
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    span = spans[-1][1] - spans[0][0]
    by_name: dict = {}
    for e in dev_ev:
        dt, c = by_name.get(e["name"], (0.0, 0))
        by_name[e["name"]] = (dt + float(e["dur"]), c + 1)
    rows = sorted(((dt, k, c) for k, (dt, c) in by_name.items()), reverse=True)
    ops = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0:
            ops.append((float(us), e.key, int(e.count)))
    ops.sort(reverse=True)
    return {
        "profile_sessions": sessions,
        "device_busy_ms_per_call": busy / reps / 1e3,
        "device_idle_share": 1.0 - busy / reps / 1e3 / step_ms,
        "profiled_wall_ms_per_call": wall_us / reps / 1e3,
        "profiled_device_span_ms_per_call": span / reps / 1e3,
        "device_launches_per_call": len(dev_ev) / reps,
        "kernels": [
            {"name": k[:80], "ms_per_call": dt / reps / 1e3, "calls_per_call": c / reps}
            for dt, k, c in rows[:12]
        ],
        "ops": [  # torch ops by the device time of their own kernels
            {"op": k[:80], "ms_per_call": us / reps / 1e3, "calls_per_call": c / reps}
            for us, k, c in ops[:15]
        ],
    }


def phase_profile(dev, results) -> None:
    """torch.profiler over 10 frames of config (a), against (a)'s
    unprofiled frame time from phase 4 (``device_profile``)."""
    import torch

    from clraytracer_tpu_torch.camera import Camera
    from clraytracer_tpu_torch.cli import build_scene
    from clraytracer_tpu_torch.config import CameraConfig, RenderConfig
    from clraytracer_tpu_torch.render import frame_inputs_from_camera, render_frame

    _tag, spec, tris, w, h = MAIN[0]
    scene = build_scene(spec, tris, device=dev)
    cfg = RenderConfig(width=w, height=h)
    frame = frame_inputs_from_camera(
        Camera.create(CameraConfig(position=CAMERA), w, h), SUN
    )
    for _ in range(3):
        render_frame(scene, frame, cfg)
    torch.cuda.synchronize()
    reps = 10
    frame_ms = results["main"][0]["frame_ms"]
    prof = device_profile(lambda: render_frame(scene, frame, cfg), reps, frame_ms)
    results["profile"] = {
        "phase": "profile", "config": "a", "frames": reps,
        "frame_ms_unprofiled": frame_ms, **prof,
    }
    emit(results["profile"])


def cli_camera(w: int, h: int):
    from clraytracer_tpu_torch.camera import Camera
    from clraytracer_tpu_torch.config import CameraConfig

    return Camera.create(CameraConfig(position=CAMERA), w, h)


def diff_frame(w: int, h: int, dev):
    """Frame inputs of the smoke camera, moved to the card once."""
    import torch

    from clraytracer_tpu_torch.render import FrameInputs, frame_inputs_from_camera

    frame = frame_inputs_from_camera(cli_camera(w, h), SUN)
    return FrameInputs(*(torch.as_tensor(x).to(dev) for x in frame))


def grads_disagree(got: dict, ref: dict) -> list:
    """Keys whose card gradients disagree with the CPU step's: aggregated
    leaves (materials, instances) to rtol 1e-3, per-row leaves (tris,
    atlas) on >= 99% of rows within 1e-3 |g| + 1e-4 max |g|; every other
    leaf zero in both. Non-finite values disagree."""
    import torch

    bad = []
    for key, r in ref.items():
        a, b = r.double().cpu(), got[key].double().cpu()
        group = key.split(".")[0]
        scale = float(a.abs().max())
        if not bool(torch.isfinite(b).all()):
            bad.append(key)
            continue
        if group in ("tris", "atlas"):
            close = (b - a).abs() <= 1e-3 * a.abs() + 1e-4 * scale
            frac = float(close.reshape(close.shape[0], -1).all(dim=1).double().mean())
            ok = frac >= 0.99
        elif group in ("materials", "instances"):
            ok = bool(((b - a).abs() <= 1e-3 * a.abs() + 1e-6 * scale).all())
        else:
            ok = not bool(a.any()) and not bool(b.any())
        if not ok:
            bad.append(key)
    return bad


def reset_counts() -> None:
    from clraytracer_tpu_torch.ops import gather_rows as gr
    from clraytracer_tpu_torch.ops import render_fused as rf
    from clraytracer_tpu_torch.ops import trace as tr

    rf.render_cuda.launches = 0
    rf.render_cuda.variant_launches = {}
    tr.trace_cuda.launches = 0
    gr.gather_rows_cuda.launches = 0
    gr.scatter_rows_cuda.launches = 0


def read_counts() -> dict:
    from clraytracer_tpu_torch.ops import gather_rows as gr
    from clraytracer_tpu_torch.ops import render_fused as rf
    from clraytracer_tpu_torch.ops import trace as tr

    return {"K2.1": tr.trace_cuda.launches, "K2.2": rf.render_cuda.launches,
            "K2.3": gr.gather_rows_cuda.launches,
            "K2.4": gr.scatter_rows_cuda.launches}


def check_gather_kernels(gathers, scatters) -> dict:
    """K2.3 and K2.4 against their plain versions and library calls on the
    step's own inputs (bounce 0's gather and its scatter, which the
    backward runs last), timed with CUDA events."""
    import torch

    from clraytracer_tpu_torch.ops import gather_rows as gr

    out = {"K2.3": {"cases": []}, "K2.4": {"cases": []}}
    for b, (table, idx) in enumerate(gathers):
        got = gr.gather_rows_cuda(table, idx)
        ref = gr.gather_rows_plain(table, idx)
        torch.cuda.synchronize()
        out["K2.3"]["cases"].append({
            "bounce": b, "bit_exact": bool(torch.equal(got, ref)),
            "max_abs_err": float((got - ref).abs().max()),
        })
    for b, (g, idx, t_rows) in enumerate(reversed(scatters)):
        got = gr.scatter_rows_cuda(g, idx, t_rows)
        ref = gr.scatter_rows_plain(g, idx, t_rows)
        mag = gr.scatter_rows_plain(g.abs(), idx, t_rows)
        torch.cuda.synchronize()
        err = (got - ref).abs()
        out["K2.4"]["cases"].append({
            "bounce": b, "max_abs_err": float(err.max()),
            "max_err_over_tol": float((err / (1e-5 * mag + 1e-7)).max()),
            "within_tol": bool((err <= 1e-5 * mag + 1e-7).all()),
            "nonzero_terms": int((g != 0).sum()), "terms": g.numel(),
        })
    out["K2.3"]["ok"] = all(c["bit_exact"] for c in out["K2.3"]["cases"])
    out["K2.4"]["ok"] = all(c["within_tol"] for c in out["K2.4"]["cases"])

    table, idx = gathers[0]
    g, gidx, t_rows = scatters[-1]
    n, w = idx.numel(), table.shape[1]
    table_t = table.t().contiguous()
    reps = 20
    bytes_moved = n * 4 + n * w * 4 + t_rows * w * 4
    # ms and library_ms: one event pair around each call; device_ms and
    # library_device_ms beside them: the card's time (``device_ms``)
    gather = lambda: gr.gather_rows_cuda(table, idx)
    lib_gather = lambda: torch.index_select(table_t, 1, idx)
    k3 = {
        "ms": event_ms(gather, reps)[0], "device_ms": device_ms(gather),
        "plain_ms": event_ms(lambda: gr.gather_rows_plain(table, idx), reps)[0],
        "library_ms": event_ms(lib_gather, reps)[0],
        "library_device_ms": device_ms(lib_gather),
        "bound_ms": bytes_moved / PEAK_BYTES * 1e3, "bound_by": "bytes",
        "bytes": bytes_moved, "shape": f"table [{table.shape[0]}, {w}], idx [{n}]",
    }
    lib_scatter = lambda: torch.zeros(w, t_rows, device=g.device).index_add_(1, gidx, g)
    adds = int((g != 0).sum())
    t_bytes = bytes_moved / PEAK_BYTES * 1e3
    t_ops = adds / PEAK_F32 * 1e3
    scatter = lambda: gr.scatter_rows_cuda(g, gidx, t_rows)
    k4 = {
        "ms": event_ms(scatter, reps)[0], "device_ms": device_ms(scatter),
        "plain_ms": event_ms(lambda: gr.scatter_rows_plain(g, gidx, t_rows), reps)[0],
        "library_ms": event_ms(lib_scatter, reps)[0],
        "library_device_ms": device_ms(lib_scatter),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes": bytes_moved, "adds": adds,
        "shape": f"g [{w}, {n}], idx [{n}] -> [{t_rows}, {w}]",
    }
    out["K2.3"].update(k3)
    out["K2.4"].update(k4)
    return out


def phase_diff(dev, results) -> None:
    """The differentiable step (``diff.image_loss_and_grads``) on the card:
    (e) the bench's grads configuration, (f) card against CPU, (g) fit."""
    import torch

    from clraytracer_tpu_torch import cli
    from clraytracer_tpu_torch.cli import build_scene
    from clraytracer_tpu_torch.diff import (
        grad_leaves,
        image_loss_and_grads,
        render_image_diff,
    )
    from clraytracer_tpu_torch.ops import gather_rows as gr
    from clraytracer_tpu_torch.render import frame_inputs_from_camera

    # ---- (e) sphere 4224 tris, 1920x1080, 2 bounces, L2 against black
    _tag, spec, tris, w, h = DIFF_E
    scene = build_scene(spec, tris, device=dev)
    frame = diff_frame(w, h, dev)
    target = torch.zeros(h, w, 3, device=dev)
    step = lambda: image_loss_and_grads(scene, frame, w, h, target=target)
    step()  # first step: tables upload
    torch.cuda.synchronize()
    # ---- the main path's own run: counts from zero
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    ms, times = event_ms(step, STEPS, STEP_WARMUP)
    peak = torch.cuda.max_memory_allocated()
    counts = read_counts()
    steps = STEPS + STEP_WARMUP
    # ---- the step's split: the forward (render + loss, building the
    # graph) alone, then the backward (autograd.grad) alone
    s_leaf, params = grad_leaves(scene)
    leaves = list(params.values())
    fwd = lambda: torch.mean((render_image_diff(s_leaf, frame, w, h) - target) ** 2)
    fwd_ms, _ = event_ms(fwd, 5, 1)
    bwd_times = []
    for i in range(6):
        loss_t = fwd()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        torch.autograd.grad(loss_t, leaves, allow_unused=True)
        b.record()
        b.synchronize()
        if i:
            bwd_times.append(a.elapsed_time(b))
    bwd_times.sort()
    del loss_t, s_leaf, params, leaves
    loss, grads = step()
    finite = all(bool(torch.isfinite(g).all()) for g in grads.values())
    nonzero = {k: float(grads[k].float().abs().max()) > 0.0
               for k in ("materials.albedo", "tris.v0", "instances.inverse_transform")}
    # ---- capture bounce inputs of one step for the kernel checks
    gathers, scatters = [], []
    real_gather, real_scatter = gr.gather_rows, gr.scatter_rows

    def rec_gather(table, idx):
        gathers.append((table.detach(), idx))
        return real_gather(table, idx)

    def rec_scatter(g, idx, t_rows):
        scatters.append((g, idx, t_rows))
        return real_scatter(g, idx, t_rows)

    gr.gather_rows, gr.scatter_rows = rec_gather, rec_scatter
    try:
        step()
    finally:
        gr.gather_rows, gr.scatter_rows = real_gather, real_scatter
    kern = check_gather_kernels(gathers, scatters)
    n_rays = gathers[0][1].numel()
    hits0 = int((gathers[0][1] != 0).sum())
    del gathers, scatters
    prof = device_profile(step, 3, ms)
    line = {
        "phase": "diff", "config": "e", "scene": spec,
        "triangles": int(scene.tris.count), "width": w, "height": h,
        "bounces": 2, "loss": float(loss),
        "step_ms": ms, "step_ms_min": times[0], "step_ms_max": times[-1],
        "mrays_per_s": w * h * 2 / (ms * 1e-3) / 1e6,
        "forward_ms": fwd_ms, "backward_ms": bwd_times[len(bwd_times) // 2],
        "steps": steps, "launches": counts,
        "launches_per_step": {k: v / steps for k, v in counts.items()},
        "peak_mem_bytes": peak, "mem_before_bytes": base_mem,
        "rays_per_bounce": n_rays, "bounce0_rays_off_row0": hits0,
        "grads_finite": finite, "grads_nonzero": nonzero,
        "grad_norms": {k: float(torch.linalg.vector_norm(grads[k].float()))
                       for k in ("materials.albedo", "tris.v0",
                                 "instances.inverse_transform")},
        "kernels_check": {k: {"ok": v["ok"], "cases": v["cases"]}
                          for k, v in kern.items()},
        "profile": prof,
    }
    line["ok"] = (
        finite and all(nonzero.values()) and kern["K2.3"]["ok"] and kern["K2.4"]["ok"]
        and counts == {"K2.1": 2 * steps, "K2.2": 0, "K2.3": 2 * steps,
                       "K2.4": 2 * steps}
    )
    results["diff"] = {"e": line, "kernels": kern}
    emit(line)
    if not line["ok"]:
        raise SystemExit("diff (e) failed")
    del grads

    # ---- (f) the card's step against the CPU step (plain versions)
    fw, fh = DIFF_CHECK_WH
    for spec_f in ("two", "sphere"):
        cpu = build_scene(spec_f, 4096, device="cpu")
        gpu = build_scene(spec_f, 4096, device=dev)
        fr_c = frame_inputs_from_camera(cli_camera(fw, fh), SUN)
        fr_g = diff_frame(fw, fh, dev)
        img_c = render_image_diff(cpu, fr_c, fw, fh, device="cpu")
        img_g = render_image_diff(gpu, fr_g, fw, fh).cpu()
        px_bad = float(((img_g - img_c).abs() > 1e-5).any(dim=-1).double().mean())
        tgt = torch.zeros(fh, fw, 3)
        loss_c, g_c = image_loss_and_grads(cpu, fr_c, fw, fh, target=tgt, device="cpu")
        reset_counts()
        loss_g, g_g = image_loss_and_grads(gpu, fr_g, fw, fh, target=tgt.to(dev))
        torch.cuda.synchronize()
        counts = read_counts()
        bad = grads_disagree(g_g, g_c)
        rel = abs(float(loss_g) - float(loss_c)) / abs(float(loss_c))
        line = {
            "phase": "diff", "config": "f", "scene": spec_f, "width": fw,
            "height": fh, "pixels_over_1e-5": px_bad, "loss_cpu": float(loss_c),
            "loss_card": float(loss_g), "loss_rel_err": rel,
            "grads_disagree": bad, "launches": counts,
            "max_rel_err": {
                k: float((g_g[k].double().cpu() - g_c[k].double()).abs().max()
                         / max(float(g_c[k].double().abs().max()), 1e-30))
                for k in ("materials.albedo", "tris.v0", "instances.inverse_transform")
            },
        }
        line["ok"] = (px_bad <= 0.01 and rel <= 1e-5 and not bad
                      and counts == {"K2.1": 2, "K2.2": 0, "K2.3": 2, "K2.4": 2})
        emit(line)
        if not line["ok"]:
            raise SystemExit(f"diff (f) {spec_f} failed")

    # ---- (g) Adam inverse rendering of ``two``'s albedo at 1249x720
    _tag, spec_g, gw, gh, n_steps = DIFF_G
    scene = build_scene(spec_g, 4096, device=dev)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    report, _fitted = cli.fit(
        scene, frame_inputs_from_camera(cli_camera(gw, gh), SUN), gw, gh,
        steps=n_steps, lr=0.05, seed=0,
    )
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    # the target render and every step trace and gather twice; no K2.4: the
    # triangle table needs no gradient when only the albedo is fitted
    want = {"K2.1": 2 * (n_steps + 1), "K2.2": 0, "K2.3": 2 * (n_steps + 1),
            "K2.4": 0}
    line = {
        "phase": "diff", "config": "g", "scene": spec_g, "width": gw,
        "height": gh, "param": "albedo", "lr": 0.05, **report,
        "fit_wall_s": wall, "launches": counts,
        "ok": report["loss_last"] < report["loss_first"] and counts == want,
    }
    emit(line)
    if not line["ok"]:
        raise SystemExit("diff (g) failed")


def phase_kernels(dev, results) -> None:
    """Holds each kernel against its plain version at the main path's shapes
    (config (a): sphere, 4224 tris, 1920x1080), times both, and prints the
    kernels line. ``launches`` are the counts of the paths' own runs
    (phase 4): K2.2 from render_frame (a)-(c), K2.1 from the trace entry (d)."""
    import torch

    from clraytracer_tpu_torch.cli import build_scene
    from clraytracer_tpu_torch.ops import render_fused as rf
    from clraytracer_tpu_torch.ops import trace as tr
    from clraytracer_tpu_torch.render import frame_inputs_from_camera

    _tag, spec, tris, w, h = MAIN[0]
    scene = build_scene(spec, tris, device=dev)
    kt, ft = tr.kernel_tables(scene), rf.frame_tables(scene)
    rays, cam = camera_rays(w, h, dev)
    n = rays.shape[1]
    cnt1 = torch.zeros(6, dtype=torch.int64, device=dev)
    got = tr.trace_cuda(kt, rays, None, cnt1)
    ref = tr.trace_plain(kt, rays)
    torch.cuda.synchronize()
    check1 = compare_trace(got, ref)
    clusters, slots = winners(got)
    del got, ref
    t_ms, _ = event_ms(lambda: tr.trace_cuda(kt, rays), 10, 2)
    t_dev = device_ms(lambda: tr.trace_cuda(kt, rays))
    tp_ms, _ = event_ms(lambda: tr.trace_plain(kt, rays), 1, 0)
    kb1 = walk_bound(("K2.1", "a", int(scene.tris.count)),
                     6 * n * 4 + walk_bytes(kt, clusters, slots) + 11 * n * 4,
                     cnt1.cpu().tolist())

    cr = rf.camera_row(frame_inputs_from_camera(cam, SUN))
    trows = rf.tile_rows(w * h)
    rows_total = -(-h // trows) * -(-w // 128) * trows
    cnt2 = torch.zeros(6, dtype=torch.int64, device=dev)
    got = rf.render_cuda(kt, ft, cr, w, h, trows, rows_total, 2, cnt2)
    ref = rf.render_fused_plain(kt, ft, cr, w, h, trows, rows_total, 2, dev)
    torch.cuda.synchronize()
    check2 = compare_options(got, ref, 0, False)
    del got, ref
    r_ms, _ = event_ms(
        lambda: rf.render_cuda(kt, ft, cr, w, h, trows, rows_total, 2), 10, 2
    )
    r_dev = device_ms(lambda: rf.render_cuda(kt, ft, cr, w, h, trows, rows_total, 2))
    rp_ms, _ = event_ms(
        lambda: rf.render_fused_plain(kt, ft, cr, w, h, trows, rows_total, 2, dev),
        1, 0,
    )
    cnt2 = cnt2.cpu().tolist()
    kb2 = walk_bound(("K2.2", "a", int(scene.tris.count)),
                     walk_bytes(kt, clusters, slots, ft) + 9 * rows_total * 128 * 4,
                     cnt2, rows_total * 128, shade=True)
    emit({"phase": "kernels_at_main_shapes", "scene": spec, "width": w, "height": h,
          "K2.1": check1, "K2.2": check2, "K2.1_bound": kb1, "K2.2_bound": kb2,
          "main_path_counts": {m["config"]: m["kernel_bound"]["counts"]
                               for m in results["main"]},
          "ptxas": results["ptxas"]})
    if not (check1["ok"] and check2["ok"]):
        raise SystemExit("a kernel disagrees with its plain version at main-path shapes")
    emit({"kernels": [
        {
            "name": "K2.1 trace (hit record)", "route": "cuda",
            "source": "clraytracer_tpu_torch/csrc/trace.cu",
            "replaces": "clraytracer_tpu/ops/trace_pallas.py:928",
            "launches": (results["trace_path"]["k21_launches"]
                         + results["engine"]["picks"]["launches"]["K2.1"]),
            "path": (f"(d) ops.trace.trace, {w}x{h} camera rays; (u) raycast of "
                     f"{PICK_POINTS} screen points and {PICK_CALLS} Engine.pick calls "
                     "(tracer=trace_best)"),
            "max_abs_err": max(results["trace_err"], check1["max_abs_err"]),
            "tolerance": (f"hit rule of tests/test_trace.py; <= {FRAME_MISMATCH_MAX} "
                          "rays not exact in (t, slot, instance); attrs rtol 1e-5 atol 1e-6"),
            "ms": t_ms, "device_ms": t_dev, "plain_ms": tp_ms, "bound_ms": kb1["bound_ms"],
            "bound_by": kb1["bound_by"], "library_ms": None,
            "shape": f"{n} camera rays, {spec} {scene.tris.count} tris",
        },
        {
            "name": "K2.2 fused frame", "route": "cuda",
            "source": "clraytracer_tpu_torch/csrc/render.cu",
            "replaces": "clraytracer_tpu/ops/render_pallas.py:109",
            "launches": (sum(m["k22_launches"] for m in results["main"])
                         + results["engine"]["launches"]["K2.2"]),
            "path": "(a)-(c) render.render_frame; (u) engine.Engine.render",
            "max_abs_err": max(results["fused_err"], check2["max_abs_err_all"]),
            "tolerance": f"<= {FRAME_MISMATCH_MAX} rays over 1e-5 on any of nine planes",
            "ms": r_ms, "device_ms": r_dev, "plain_ms": rp_ms, "bound_ms": kb2["bound_ms"],
            "bound_by": kb2["bound_by"], "library_ms": None,
            "shape": f"{w}x{h}x2 bounces, {spec} {scene.tris.count} tris",
        },
        *option_kernel_entries(results),
        *twophase_kernel_entries(results),
        *split_kernel_entries(results),
        *diff_kernel_entries(results),
        *sharded_kernel_entries(results),
    ]})


def twophase_kernel_entries(results) -> list:
    """The kernels-line entries of the two-phase path and of ray mode:
    K2.1 with its launches in (n)-(q), timed at (o)'s shadow rays (the
    launch with a live mask), its error the worst of every recorded launch;
    K2.2 in ray mode with its launches in (r), timed at (r)'s rays, its
    error the worst of (r)'s checks and of phase options' ray cases."""
    cells = results["twophase_cells"]
    o = next(c for c in cells if c["config"] == "o")
    shadow = o["k21_checks"][1]
    r = results["ray_cell"]
    ray_errs = [c["max_abs_err_within"] for c in results["options"]
                if c["variant"].startswith("rays")]
    ray_errs += [r["check"]["max_abs_err_within"], r["check_gi"]["max_abs_err_within"]]
    return [
        {
            "name": "K2.1 trace, two-phase frame", "route": "cuda",
            "source": "clraytracer_tpu_torch/csrc/trace.cu",
            "replaces": "clraytracer_tpu/ops/trace_pallas.py:928",
            "launches": sum(c["launches"]["K2.1"] for c in cells),
            "path": "(n)-(q) render.render_frame, two-phase (bounces and shadow rays)",
            "max_abs_err": max(ch["max_abs_err"] for c in cells for ch in c["k21_checks"]),
            "tolerance": (f"hit rule of tests/test_trace.py; <= {FRAME_MISMATCH_MAX} "
                          "rays not exact in (t, slot, instance); dead lanes -BIG"),
            "ms": shadow["ms"], "device_ms": shadow["device_ms"],
            "plain_ms": shadow["plain_ms"], "bound_ms": shadow["bound_ms"],
            "bound_by": shadow["bound_by"], "library_ms": None,
            "shape": (f"(o) shadow rays: {shadow['rays']} rays, {shadow['live_rays']} live, "
                      f"{o['scene']} {o['triangles']} tris"),
        },
        {
            "name": "K2.2 fused frame, ray mode", "route": "cuda",
            "source": "clraytracer_tpu_torch/csrc/render.cu",
            "replaces": "clraytracer_tpu/ops/render_pallas.py:109",
            "entry": "render_fused (clraytracer_tpu/ops/render_pallas.py:1115)",
            "launches": r["launches"]["K2.2"],
            "path": f"(r) render.trace_planar, {r['width']}x{r['height']} camera rays",
            "max_abs_err": max(ray_errs),
            "tolerance": (f"pool indices exact; other planes within 1e-5 on all but "
                          f"{FRAME_MISMATCH_MAX} rays; on camera rays equal to camera mode"),
            "ms": r["kernel_ms"], "device_ms": r["kernel_device_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["kernel_bound_ms"],
            "bound_by": r["kernel_bound_by"], "library_ms": None,
            "shape": f"{r['rays']} rays x2 bounces, {r['scene']} {r['triangles']} tris",
        },
    ]


def split_kernel_entries(results) -> list:
    """The kernels-line entries of the carry instantiations, from (s):
    carry-out (camera mode, bounce 0) and carry-in (ray mode, from global
    bounce 1) timed at (sa)'s shapes, carry-out with shadows at (sk)'s;
    each one's launches in every split cell's main-path run, its error the
    worst of its plain checks (phase options and (s))."""
    cells = {c["config"]: c for c in results["split_cells"]}
    out = []
    for name, tag, which in (("carry_out", "sa", "carry_out"),
                             ("carry_out+shadows", "sk", "carry_out"),
                             ("rays+carry_in", "sa", "carry_in")):
        c = cells[tag]
        errs = [o["max_abs_err_within"] for o in results["options"] if o["variant"] == name]
        errs += [x["plain"][which]["max_abs_err_within"] for x in cells.values()
                 if x[f"{which}_variant"] == name]
        b = c[f"{which}_bound"]
        out.append({
            "name": f"K2.2 fused frame, {name}", "route": "cuda",
            "source": "clraytracer_tpu_torch/csrc/render.cu",
            "replaces": "clraytracer_tpu/ops/render_pallas.py:109",
            "entry": ("render_fused_camera(split_rebin=True) "
                      "(clraytracer_tpu/ops/render_pallas.py:1204, carry :121-123)"),
            "launches": sum(x["k22_variant_launches"].get(name, 0) for x in cells.values()),
            "path": "(s) ops.render_fused.render_fused_camera(split_rebin=True)",
            "max_abs_err": max(errs),
            "tolerance": f"within 1e-5 on all but {FRAME_MISMATCH_MAX} rays",
            "ms": c["kernels"][f"{which}_ms"], "device_ms": c["kernels"][f"{which}_device_ms"],
            "plain_ms": c["plain"][which]["plain_ms"],
            "bound_ms": b["bound_ms"], "bound_by": b["bound_by"], "library_ms": None,
            "shape": (f"{c['width']}x{c['height']}, 1 bounce "
                      f"({'bounce 0' if which == 'carry_out' else 'bounce 1'}), "
                      f"{c['scene']} {c['triangles']} tris"),
            "plain_shape": c["plain"]["checked"],
        })
    return out


def option_kernel_entries(results) -> list:
    """One kernels-line entry per K2.2 instantiation that an option cell
    drives ((h)-(k)): its launches in that cell's main-path run, its error
    against the plain version (at the cell's shapes, on its strip and in
    phase options), its ms at the cell's shapes beside the plain version's
    and its bound."""
    out = []
    imported = results["imported"]
    for line, (tag, spec, _tris, w, h, cfg_kw) in zip(results["option_cells"], OPTION_CELLS):
        errs = [c["max_abs_err_within"] for c in results["options"]
                if c["variant"] == line["variant"]]
        errs += [line["check"]["max_abs_err_within"], line["check_full"]["max_abs_err_within"]]
        launches = line["launches"]["K2.2_variants"].get(line["variant"], 0)
        path = f"({tag}) render.render_frame, {spec}, {cfg_kw or 'defaults'}"
        if line["variant"] == imported["variant"]:
            # (t)'s imported scene runs the same instantiation on its main path
            launches += imported["launches"]["K2.2_variants"].get(line["variant"], 0)
            path += "; (t) render.render_frame, the imported museum-class scene, defaults"
            errs.append(imported["band_check"]["max_abs_err_within"])
        out.append({
            "name": f"K2.2 fused frame, {line['variant']}", "route": "cuda",
            "source": "clraytracer_tpu_torch/csrc/render.cu",
            "replaces": "clraytracer_tpu/ops/render_pallas.py:109",
            "launches": launches,
            "path": path,
            "max_abs_err": max(errs),
            "tolerance": (f"pool indices exact; other planes within 1e-5 on all but "
                          f"{FRAME_MISMATCH_MAX} rays"),
            "ms": line["kernel_ms"], "device_ms": line["kernel_device_ms"],
            "plain_ms": line["plain_ms"],
            "bound_ms": line["kernel_bound_ms"], "bound_by": line["kernel_bound_by"],
            "library_ms": None,
            "shape": f"{w}x{h}x{line['bounces']} bounces, {spec} {line['triangles']} tris",
            "plain_shape": line["plain_frame"],
        })
    return out


def diff_kernel_entries(results) -> list:
    """K2.3 and K2.4 entries of the kernels line, from phase diff (e)."""
    e, kern = results["diff"]["e"], results["diff"]["kernels"]
    out = []
    for key, name, src, fn in (
        ("K2.3", "K2.3 gather rows (diff forward)", "clrt_gather_rows",
         "clraytracer_tpu/ops/gather_pallas.py:77"),
        ("K2.4", "K2.4 scatter rows (diff backward)", "clrt_scatter_rows",
         "clraytracer_tpu/ops/gather_pallas.py:110"),
    ):
        k = kern[key]
        out.append({
            "name": name, "route": "cuda",
            "source": "clraytracer_tpu_torch/csrc/gather.cu",
            "entry": src, "replaces": fn,
            "launches": e["launches"][key],
            "path": f"(e) diff.image_loss_and_grads, {e['width']}x{e['height']}x2",
            "max_abs_err": max(c["max_abs_err"] for c in k["cases"]),
            "tolerance": ("bit-exact" if key == "K2.3"
                          else "1e-5 * sum|g| (plain scatter of |g|) + 1e-7"),
            "ms": k["ms"], "device_ms": k["device_ms"], "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "library_ms": k["library_ms"], "library_device_ms": k["library_device_ms"],
            "shape": k["shape"],
        })
    return out


# ---------------------------------------------------------------------------
# (t) a museum-class imported scene: OBJ/MTL, .clm and .clmz files with PNG
# maps, written from the port's procedural meshes
# ---------------------------------------------------------------------------

# the JAX ``museum`` scene (cli.py:75-94): three imported meshes, ~160k
# triangles, ~45 textures in a 64-texture pool, the second mesh at
# translation(0, 25, 0) and the third at translation(0, 0, 3)
MUSEUM_TEX = 512  # texture side: 45 maps of 512x512, ~11.8M texels
MUSEUM_WH = (1920, 1080)
MUSEUM_CAMERA = dict(position=(0.0, 3.0, 14.0), pitch_deg=-8.0)
MUSEUM_REF_WH = (320, 240)  # the reference tracers' frame (trace_wavefront)


def png_bytes(rgb8, filters=(0, 1, 2, 3, 4)) -> bytes:
    """An 8-bit RGB PNG of ``rgb8`` [H, W, 3], image row y filtered with
    ``filters[y % len(filters)]`` (PNG spec section 9: none, Sub, Up,
    Average, Paeth), so a decoder meets every filter type."""
    import struct
    import zlib

    import numpy as np

    x = np.ascontiguousarray(rgb8, np.uint8)
    h, w, _ = x.shape
    cur = x.reshape(h, w * 3).astype(np.int16)
    zrow, zcol = np.zeros((1, w * 3), np.int16), np.zeros((h, 3), np.int16)
    up = np.vstack([zrow, cur[:-1]])
    left = np.hstack([zcol, cur[:, :-3]])
    upleft = np.hstack([zcol, up[:, :-3]])
    p = left + up - upleft
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
    preds = np.stack([np.zeros_like(cur), left, up, (left + up) >> 1, paeth])
    ft = np.asarray(filters, np.int64)[np.arange(h) % len(filters)]
    rows = ((cur - preds[ft, np.arange(h)]) % 256).astype(np.uint8)
    raw = np.hstack([ft[:, None].astype(np.uint8), rows]).tobytes()

    def chunk(tag: bytes, data: bytes) -> bytes:
        body = tag + data
        return (struct.pack(">I", len(data)) + body
                + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def museum_texture(seed: int, size: int):
    """A [size, size, 3] u8 map: a seeded checker of two colours over a
    diagonal ramp, with noise (at most 199 + 47 + 7, so no clipping)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    i = np.arange(size)
    cells = int(rng.integers(4, 17))
    c0, c1 = rng.integers(0, 200, (2, 3), dtype=np.uint8)
    cell = i * cells // size
    chk = (cell[:, None] + cell[None, :]) % 2 == 1
    ramp = ((i[:, None] + i[None, :]) * 48 // (2 * size)).astype(np.uint8)
    img = np.where(chk[..., None], c0, c1) + ramp[..., None]
    return img + rng.integers(0, 8, (size, size, 3), dtype=np.uint8)


def obj_text(groups, mtllib: str) -> str:
    """OBJ text of ``groups`` [(material name, corners)], each corners
    (pos [F, k, 3], uv [F, k, 2], normal [F, k, 3]) for F faces of k
    corners: v/vt/vn records deduplicated, then per group its ``usemtl``
    and ``f v/vt/vn ...`` faces."""
    import io

    import numpy as np

    out = io.StringIO()
    out.write(f"# museum-class test mesh\nmtllib {mtllib}\n")
    refs = []
    for a, tag in enumerate(("v", "vt", "vn")):
        flat = np.concatenate([c[a].reshape(-1, c[a].shape[-1]) for _, c in groups])
        uniq, inv = np.unique(flat.astype(np.float32), axis=0, return_inverse=True)
        np.savetxt(out, uniq, fmt=tag + " %.6f" * uniq.shape[1])
        refs.append(inv.reshape(-1) + 1)
    at = 0
    for name, (pos, _uv, _n) in groups:
        f, k = pos.shape[:2]
        idx = np.stack([r[at:at + f * k] for r in refs], axis=-1).reshape(f, k * 3)
        at += f * k
        out.write(f"usemtl {name}\n")
        np.savetxt(out, idx, fmt="f" + " %d/%d/%d" * k)
    return out.getvalue()


def _soup(mesh):
    """A MeshData soup → triangle corners (pos, uv, normal) [F, 3, *]."""
    import numpy as np

    st = lambda a, b, c: np.stack([a, b, c], axis=1)
    return (st(mesh.v0, mesh.v1, mesh.v2), st(mesh.uv0, mesh.uv1, mesh.uv2),
            st(mesh.n0, mesh.n1, mesh.n2))


def _quad_grid(n: int, corner, du, dv, normal, uv_scale: float):
    """An n x n grid of quads (4-corner faces) spanning corner + [0,1]^2 of
    (du, dv), uvs tiling ``uv_scale`` times."""
    import numpy as np

    i, j = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    i, j = i.reshape(-1, 1), j.reshape(-1, 1)
    a = np.array([[0, 0], [1, 0], [1, 1], [0, 1]])  # corner order
    s = (i + a[None, :, 0]) / n
    t = (j + a[None, :, 1]) / n
    c, du, dv = (np.asarray(x, np.float32) for x in (corner, du, dv))
    pos = c + s[..., None] * du + t[..., None] * dv
    uv = np.stack([s, t], axis=-1) * uv_scale
    nrm = np.broadcast_to(np.asarray(normal, np.float32), pos.shape)
    return pos.astype(np.float32), uv.astype(np.float32), nrm.copy()


def museum_meshes():
    """The three meshes of (t) as OBJ groups: {name: [(material, corners)]}.
    atrium (the sponza role): a hall of 64 spheres on a quad-grid floor
    with back and side walls, 20 materials; gallery (sibenik, placed 25
    up): 36 larger spheres, 14 materials; figure (nanosuit, placed 3
    forward): one dense sphere in 8 latitude bands. 161,360 triangles."""
    import numpy as np

    from clraytracer_tpu_torch.scene.procedural import sphere_field, uv_sphere

    out = {}
    field = _soup(sphere_field(n_side=8, spacing=3.0, n_lat=16, n_lon=32))
    per = field[0].shape[0] // 64
    groups = []
    for m in range(18):  # spheres k with k % 18 == m share material m
        take = np.concatenate([np.arange(k * per, (k + 1) * per)
                               for k in range(64) if k % 18 == m])
        groups.append((f"atrium_{m:02d}", tuple(c[take] for c in field)))
    groups.append(("atrium_floor", _quad_grid(40, (-30, 0, -30), (60, 0, 0), (0, 0, 60),
                                              (0, 1, 0), 12.0)))
    walls = [_quad_grid(20, (-30, 0, -20), (60, 0, 0), (0, 30, 0), (0, 0, 1), 6.0),
             _quad_grid(20, (-30, 0, 30), (0, 0, -60), (0, 30, 0), (1, 0, 0), 6.0),
             _quad_grid(20, (30, 0, -30), (0, 0, 60), (0, 30, 0), (-1, 0, 0), 6.0)]
    groups.append(("atrium_walls", tuple(np.concatenate(p) for p in zip(*walls))))
    out["atrium"] = groups

    field = _soup(sphere_field(n_side=6, spacing=5.0, n_lat=20, n_lon=40))
    per = field[0].shape[0] // 36
    out["gallery"] = [
        (f"gallery_{m:02d}", tuple(
            c[np.concatenate([np.arange(k * per, (k + 1) * per) for k in range(36)
                              if k % 14 == m])] for c in field))
        for m in range(14)
    ]
    fig = _soup(uv_sphere(1.5, 100, 200))
    band = np.minimum((fig[0][:, :, 1].mean(axis=1) + 1.5) / 3.0 * 8, 7).astype(int)
    out["figure"] = [(f"figure_{m}", tuple(c[band == m] for c in fig)) for m in range(8)]
    return out


def write_museum(root, tex: int = MUSEUM_TEX) -> dict:
    """Write (t)'s three meshes as ``<root>/<name>/<name>.obj`` + ``.mtl``
    with one ``map_Kd`` PNG per material (42) and a ``map_Ks`` for every
    fourteenth (3), each written with the five row filters in turn.
    Returns {name: obj path}, and under "_stats" the counts."""
    from pathlib import Path

    root = Path(root)
    paths, n_tex, n_tris, n_quads = {}, 0, 0, 0
    seed = 0
    for name, groups in museum_meshes().items():
        d = root / name
        d.mkdir(parents=True, exist_ok=True)
        mtl = []
        for mat, corners in groups:
            seed += 1
            (d / f"{mat}.png").write_bytes(png_bytes(museum_texture(seed, tex)))
            n_tex += 1
            mtl += [f"newmtl {mat}", f"Kd {0.5 + 0.5 * (seed % 3) / 2:.3f} 0.9 0.8",
                    "Ks 0.5 0.5 0.5", f"Ns {20 + seed % 60}", "d 0.6", f"map_Kd {mat}.png"]
            if seed % 14 == 0:
                (d / f"{mat}_spec.png").write_bytes(
                    png_bytes(museum_texture(1000 + seed, tex), filters=(4, 3, 1)))
                mtl.append(f"map_Ks {mat}_spec.png")
                n_tex += 1
            k = corners[0].shape[1]
            n_tris += corners[0].shape[0] * (k - 2)
            n_quads += corners[0].shape[0] if k == 4 else 0
        (d / f"{name}.mtl").write_text("\n".join(mtl) + "\n")
        (d / f"{name}.obj").write_text(obj_text(groups, f"{name}.mtl"))
        paths[name] = d / f"{name}.obj"
    paths["_stats"] = {"textures": n_tex, "triangles": n_tris, "quad_faces": n_quads}
    return paths


MUSEUM_RAYS = 4096  # seeded camera rays of the reference tracers' hit check


class StepTimer:
    """Host seconds and calls of named steps, by standing a timing wrapper
    in for a module attribute while a ``with`` block runs."""

    def __init__(self):
        self.seconds: dict = {}
        self.calls: dict = {}
        self._undo: list = []

    def wrap(self, module, attr: str, step: str):
        real = getattr(module, attr)

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return real(*args, **kwargs)
            finally:
                self.seconds[step] = self.seconds.get(step, 0.0) + time.perf_counter() - t0
                self.calls[step] = self.calls.get(step, 0) + 1

        setattr(module, attr, timed)
        self._undo.append((module, attr, real))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        for module, attr, real in reversed(self._undo):
            setattr(module, attr, real)
        self._undo.clear()


def museum_frame(w: int, h: int):
    from clraytracer_tpu_torch.camera import Camera
    from clraytracer_tpu_torch.config import CameraConfig
    from clraytracer_tpu_torch.render import frame_inputs_from_camera

    return frame_inputs_from_camera(Camera.create(CameraConfig(**MUSEUM_CAMERA), w, h), SUN)


def build_museum(paths, dev, timer: StepTimer):
    """(t)'s scene as the JAX ``museum`` scene builds its own (cli.py:75-94):
    a 64-texture pool, the procedural sky, the three meshes (atrium from
    its OBJ, gallery through its ``.clmz`` cache, figure from its
    ``.clm``), the second placed 25 up and the third 3 forward. Host
    seconds by step go to ``timer``; returns (scene on ``dev``, build s,
    upload s)."""
    import torch

    from clraytracer_tpu_torch import math3d
    from clraytracer_tpu_torch.config import PoolConfig
    from clraytracer_tpu_torch.runtime import fastobj
    from clraytracer_tpu_torch.scene import SceneBuilder
    from clraytracer_tpu_torch.scene import builder as builder_mod
    from clraytracer_tpu_torch.scene import cache, clm, textures
    from clraytracer_tpu_torch.scene import procedural_tex as ptex

    timer.wrap(cache, "load_obj", "obj_parse")
    timer.wrap(cache, "load_mesh_cache", "clmz_load")
    timer.wrap(clm, "load_clm", "clm_load")
    timer.wrap(textures, "decode_rgb8", "image_decode")
    timer.wrap(fastobj, "build_bvh_native", "bvh_build")
    timer.wrap(builder_mod, "build_clusters", "cluster_tables")
    with timer:
        t0 = time.perf_counter()
        b = SceneBuilder(PoolConfig(max_textures=64))
        b.import_procedural(ptex.sky_gradient(512, 256))
        atrium = b.import_mesh(paths["atrium"], use_cache=False)
        gallery = b.import_mesh(paths["gallery"])
        figure = b.import_mesh(paths["figure"].with_suffix(".clm"))
        b.add_instance(atrium)
        b.add_instance(gallery, math3d.translation(0.0, 25.0, 0.0))
        b.add_instance(figure, math3d.translation(0.0, 0.0, 3.0))
        scene = b.build(device="cpu")
        build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    scene = scene.to(dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return scene, build_s, time.perf_counter() - t0


def compare_hits(ref, got) -> dict:
    """Two SceneHits over the same rays: rays whose hit, triangle or
    instance differ, and the largest t difference where they agree."""
    same = (ref.hit == got.hit) & (ref.tri == got.tri) & (ref.instance == got.instance)
    both = same & ref.hit
    dt = (ref.t - got.t)[both].abs()
    return {"rays_differing": int((~same).sum()), "hits": int(ref.hit.sum()),
            "max_abs_t_err": float(dt.max()) if dt.numel() else 0.0}


def phase_imported(dev, results) -> None:
    """(t): a museum-class imported scene on the main path. Writes three
    OBJ/MTL meshes with PNG maps (``write_museum``), one through
    ``save_clm`` and one through the ``.clmz`` cache; drives the CLI's
    ``render --scene <obj>``, ``snapshot`` and ``render --scene
    <.clsnap.npz>`` (the two PNGs byte-equal), then ``render.render_frame``
    on the three-instance scene at MUSEUM_WH with the default RenderConfig
    (counts from zero: one K2.2 atlas-1 launch a frame, no K2.1); K2.2
    against its plain version on a band of its own launch; the port's own
    image decoder on every map against the build's decode (PIL's where it
    imports); the snapshot round trip (frame bit-equal); the reference tracers on the card
    (``trace_wavefront`` through render_frame at MUSEUM_REF_WH;
    ``trace_bvh``, ``trace_brute`` and ``trace_wavefront`` on MUSEUM_RAYS
    seeded camera rays against K2.1, the rays that differ counted; brute
    within FRAME_MISMATCH_MAX)."""
    import os
    import tempfile
    from pathlib import Path

    import numpy as np
    import torch

    from clraytracer_tpu_torch import cli
    from clraytracer_tpu_torch.config import RenderConfig
    from clraytracer_tpu_torch.ops import render_fused as rf
    from clraytracer_tpu_torch.ops import trace as tr
    from clraytracer_tpu_torch.ops.trace_ref import trace_brute, trace_bvh
    from clraytracer_tpu_torch.ops.trace_wavefront import trace_wavefront
    from clraytracer_tpu_torch.render import render_frame
    from clraytracer_tpu_torch.runtime.build import native_lib
    from clraytracer_tpu_torch.scene import cache, clm, obj
    from clraytracer_tpu_torch.scene import imagefile
    from clraytracer_tpu_torch.scene.checkpoint import load_scene, save_scene
    from clraytracer_tpu_torch.scene.textures import decode_rgb8, image_decoder

    t_phase = time.perf_counter()
    w, h = MUSEUM_WH
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        paths = write_museum(root)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        clm.save_clm(paths["figure"].with_suffix(".clm"), obj.load_obj(paths["figure"]))
        save_clm_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        cache.import_mesh(paths["gallery"])  # parses the OBJ, writes gallery.clmz
        clmz_write_s = time.perf_counter() - t0
        timer = StepTimer()
        scene, build_s, upload_s = build_museum(paths, dev, timer)
        tris = int(scene.tris.count)
        # the port's own decoder on every map, against the decode the build
        # took (PIL's where it imports): the same bytes
        maps = sorted(root.glob("*/*.png"))
        t0 = time.perf_counter()
        own = [imagefile.decode_image(m) for m in maps]
        own_s = time.perf_counter() - t0
        own_equal = all(np.array_equal(a, decode_rgb8(m)) for a, m in zip(own, maps))
        del own
        import_steps = {
            "write_files_s": write_s, "save_clm_s": save_clm_s,
            "clmz_first_import_s": clmz_write_s,
            "obj_parser": "native" if native_lib() is not None else "python",
            "image_decoder": image_decoder(), **{f"{k}_s": v for k, v in timer.seconds.items()},
            "port_decoder": {"maps": len(maps), "seconds": own_s, "equal": own_equal,
                             "unfilter": "native" if native_lib() is not None else "python"},
            "calls": dict(timer.calls), "build_total_s": build_s, "upload_s": upload_s,
        }
        # ---- the CLI: render an OBJ, snapshot it, render the snapshot
        cam = ["--camera-pos", *(str(c) for c in MUSEUM_CAMERA["position"]),
               "--pitch", str(MUSEUM_CAMERA["pitch_deg"]), "--sun-angle", str(SUN),
               "--width", str(w), "--height", str(h), "--device", dev.type]
        snap = root / "atrium.clsnap.npz"
        cli_s = {}
        for step, argv in (
            ("render_obj", ["render", "--scene", str(paths["atrium"]), *cam,
                            "-o", str(root / "obj.png")]),
            ("snapshot", ["snapshot", "--scene", str(paths["atrium"]), "--device", dev.type,
                          "-o", str(snap)]),
            ("render_snapshot", ["render", "--scene", str(snap), *cam,
                                 "-o", str(root / "snap.png")]),
        ):
            t0 = time.perf_counter()
            if cli.main(argv) != 0:
                raise SystemExit(f"imported cell: cli {step} failed")
            cli_s[step] = time.perf_counter() - t0
        cli_png_equal = (root / "obj.png").read_bytes() == (root / "snap.png").read_bytes()

        # ---- the hit share of the camera rays (K2.1)
        cfg = RenderConfig(width=w, height=h)
        frame = museum_frame(w, h)
        rays, _ = camera_rays(w, h, dev, frame)
        kt = tr.kernel_tables(scene)
        k21 = tr.trace_cuda(kt, rays)
        hit0 = k21[0].abs() < tr.BIG
        hit_share = float(hit0.float().mean())
        clusters, slots = winners(k21)
        del k21

        # ---- the main path's own run: counts from zero
        img = render_frame(scene, frame, cfg)  # first frame: tables upload
        torch.cuda.synchronize()
        reset_counts()
        ms, times = event_ms(lambda: render_frame(scene, frame, cfg), FRAMES, WARMUP)
        frames = FRAMES + WARMUP
        launches = {"K2.2": rf.render_cuda.launches, "K2.1": tr.trace_cuda.launches,
                    "K2.2_variants": dict(rf.render_cuda.variant_launches)}
        frame_host_ms = host_ms(lambda: render_frame(scene, frame, cfg), FRAMES)
        mode = rf.atlas_mode_of(scene)
        name = rf.variant(mode, False, False)
        opts = dict(atlas_mode=mode, shadows=False, gi_seed=None)
        args = option_args(scene, frame, w, h, cfg.bounces)
        ft, trows, rows_total = args[1], args[5], args[6]
        n = rows_total * 128
        counters = torch.zeros(6, dtype=torch.int64, device=dev)
        out = rf.render_cuda(*args, counters, **opts)
        kms, _ = event_ms(lambda: rf.render_cuda(*args, **opts), 10, 2)
        kdev = device_ms(lambda: rf.render_cuda(*args, **opts))
        cnt = counters.cpu().tolist()
        kb = variant_bound(kt, ft, cnt, clusters, slots, n, cfg.bounces, mode, False)
        # K2.2 against its plain version on a band of its own launch,
        # centred on the camera rays' hits
        y0 = band_start(hit0, w, h, trows, CHECK_BAND_ROWS)
        pargs = band_args(args, y0, CHECK_BAND_ROWS)
        band = band_index(w, trows, y0, CHECK_BAND_ROWS, dev)
        keep = []
        plain_ms, _ = event_ms(
            lambda: keep.append(rf.render_fused_plain(*pargs, dev, **opts)), 1, 0)
        band_check = compare_options(out[:, band], keep.pop(), mode, False)
        band_hits = int(hit0[band].sum())
        out3 = out.reshape(-1, rows_total, 128)
        finish_ms = event_ms(lambda: rf._finish_frame(scene, out3, mode, False), 10, 2)[0]
        del out, out3
        prof = device_profile(lambda: render_frame(scene, frame, cfg), 5, ms)
        img = render_frame(scene, frame, cfg)
        finite = bool(torch.isfinite(img).all())

        # ---- the snapshot round trip
        t0 = time.perf_counter()
        save_scene(scene, root / "museum.clsnap.npz")
        snap_save_s = time.perf_counter() - t0
        snap_bytes = os.path.getsize(root / "museum.clsnap.npz")
        t0 = time.perf_counter()
        restored, _ = load_scene(root / "museum.clsnap.npz", device=dev)
        torch.cuda.synchronize()
        snap_load_s = time.perf_counter() - t0
        snap_equal = bool(torch.equal(render_frame(restored, frame, cfg), img))
        del restored

        # ---- the reference tracers (plain torch) on the card
        rw, rh = MUSEUM_REF_WH
        rframe = museum_frame(rw, rh)
        rcfg = RenderConfig(width=rw, height=rh)
        before = (rf.render_cuda.launches, tr.trace_cuda.launches)
        keep = []
        wave_ms, _ = event_ms(lambda: keep.append(
            render_frame(scene, rframe, rcfg, tracer=trace_wavefront)), 2, 1)
        wave_img = keep.pop()
        wave_launches = (rf.render_cuda.launches - before[0], tr.trace_cuda.launches - before[1])
        k22_small = render_frame(scene, rframe, rcfg)
        wave_px = int(((wave_img - k22_small).abs() > 1e-5).any(dim=-1).sum())
        g = torch.Generator(device="cpu").manual_seed(0)
        pick = torch.randperm(rays.shape[1], generator=g)[:MUSEUM_RAYS].to(dev)
        sub = rays[:, pick].contiguous()
        ref = tr.trace(scene, sub[:3], sub[3:])
        tracers = {}
        for tname, fn in (("wavefront", trace_wavefront), ("bvh", trace_bvh),
                          ("brute", trace_brute)):
            keep = []
            t_ms, _ = event_ms(lambda: keep.append(fn(scene, sub[:3], sub[3:])), 1, 1)
            tracers[tname] = {"ms": t_ms, **compare_hits(ref, keep.pop())}
        torch.cuda.synchronize()
    line = {
        "phase": "imported", "config": "t", "scene": "museum-class OBJ/.clm/.clmz",
        "files": paths["_stats"], "triangles": tris, "materials": int(scene.materials.count),
        "textures": int(scene.atlas.num_textures), "texels": int(scene.atlas.texels.shape[0]),
        "instances": int(scene.instances.count), "atlas_mode": mode, "variant": name,
        "width": w, "height": h, "bounces": cfg.bounces, "camera": MUSEUM_CAMERA,
        "import": import_steps, "cli_s": cli_s, "cli_png_equal": cli_png_equal,
        "hit_share": hit_share,
        "frame_ms": ms, "frame_ms_min": times[0], "frame_ms_max": times[-1],
        "frame_host_ms": frame_host_ms, "mrays_per_s": w * h * cfg.bounces / (ms * 1e-3) / 1e6,
        "kernel_ms": kms, "kernel_device_ms": kdev, "plain_ms": plain_ms,
        "kernel_bound_ms": kb["bound_ms"], "kernel_bound_by": kb["bound_by"],
        "kernel_bound": kb, "finish_ms": finish_ms, "launches": launches, "frames": frames,
        "band_check": {"frame": f"{w}x{CHECK_BAND_ROWS} band (rows {y0}-"
                       f"{y0 + CHECK_BAND_ROWS - 1}) of {w}x{h}", "band_hits": band_hits,
                       **band_check},
        "profile": prof, "finite": finite, "mean": float(img.mean()),
        "snapshot": {"save_s": snap_save_s, "load_s": snap_load_s, "bytes": snap_bytes,
                     "frame_bit_equal": snap_equal},
        "reference_tracers": {
            "render_frame_wavefront": {"frame": f"{rw}x{rh}", "ms": wave_ms,
                                       "kernel_launches": wave_launches,
                                       "pixels_differing_from_k22_frame": wave_px},
            "rays": MUSEUM_RAYS, "against": "K2.1 (ops.trace.trace)", **tracers,
        },
        "phase_s": time.perf_counter() - t_phase,
    }
    line["ok"] = (
        finite and band_check["ok"] and band_hits > 0 and snap_equal and cli_png_equal
        and own_equal and len(maps) == paths["_stats"]["textures"]
        and hit_share >= 0.5 and mode == 1 and tris >= 160_000
        and 40 <= line["materials"] - 1 <= 48
        and launches["K2.2"] == frames and launches["K2.2_variants"] == {name: frames}
        and launches["K2.1"] == 0 and wave_launches == (0, 0)
        and tracers["brute"]["rays_differing"] <= FRAME_MISMATCH_MAX
    )
    results["imported"] = line
    results["fused_err"] = max(results["fused_err"], band_check["max_abs_err_within"])
    emit(line)
    if not line["ok"]:
        raise SystemExit("imported cell (t) failed")


# ---------------------------------------------------------------------------
# (u) the frame loop: engine.Engine, picking, the bench twin, the live viewer
# ---------------------------------------------------------------------------

# (a)'s scene and size through engine.Engine with the reference's 80 ms
# frame watchdog (Renderer.cpp:370-371), the instance turning and the camera
# moving every frame
ENGINE_CELL = ("u", "sphere", 4096, 1920, 1080)
ENGINE_WATCHDOG_MS = 80.0
TICK_TRIALS = 5  # ticks timed on (c)'s million-triangle sphere
PICK_POINTS = 4096  # seeded screen points through one raycast
PICK_CALLS = 64  # single picks timed, per tracer
VIEWER_WH = (480, 320)
VIEWER_FRAMES = 5
# the screen point (top-down mouse coordinates) of the centre (-2, 1, 0) of
# ``two``'s sphere at VIEWER_WH, the viewer's camera unmoved
VIEWER_PICK = (186, 140)


def engine_step(eng, i: int) -> float:
    """One frame of cell (u): instance 0 turned to 0.05*i rad, the camera
    looked and moved (the signs alternate, so the view stays on the
    sphere), ``tick``, ``render``, ``end_frame``. Returns the tick's host
    ms."""
    from clraytracer_tpu_torch import math3d

    s = 1.0 if i % 2 else -1.0
    eng.set_instance_transform(0, math3d.rotation_y(0.05 * i))
    eng.update_camera(mouse_delta=(2.0 * s, 1.0 * s), move=(0.3 * s, 0.1 * s, 0.2))
    t0 = time.perf_counter()
    eng.tick()
    tick_ms = (time.perf_counter() - t0) * 1e3
    eng.render()
    eng.end_frame()
    return tick_ms


def engine_ticks_large(dev, w: int, h: int) -> dict:
    """Ticks on (c)'s 1,002,000-triangle sphere: host ms and ms with the
    card drained after it, and whether the traversal's geometry tables
    (``kernel_tables``) are the same tensors after the ticks."""
    import torch

    from clraytracer_tpu_torch import math3d
    from clraytracer_tpu_torch.cli import scene_builder
    from clraytracer_tpu_torch.config import CameraConfig, RenderConfig
    from clraytracer_tpu_torch.engine import Engine
    from clraytracer_tpu_torch.ops import render_fused as rf
    from clraytracer_tpu_torch.ops import trace as tr

    t0 = time.perf_counter()
    eng = Engine(scene_builder("sphere", TRIS_LARGE), RenderConfig(width=w, height=h),
                 CameraConfig(position=CAMERA))
    eng.start()
    eng.render()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    kt0, ft0 = tr.kernel_tables(eng.scene), rf.frame_tables(eng.scene)
    host, synced = [], []
    for i in range(TICK_TRIALS):
        eng.set_instance_transform(0, math3d.rotation_y(0.05 * (i + 1)))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.tick()
        host.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        synced.append((time.perf_counter() - t0) * 1e3)
    img = eng.render()
    kt1, ft1 = tr.kernel_tables(eng.scene), rf.frame_tables(eng.scene)
    reused = all(getattr(kt1, f).data_ptr() == getattr(kt0, f).data_ptr()
                 for f in ("planes", "attrs", "hyper_box", "super_box", "cluster_box",
                           "tri_gid", "ranges")) and ft1.tex.data_ptr() == ft0.tex.data_ptr()
    return {"triangles": int(eng.scene.tris.count), "build_and_first_frame_s": build_s,
            "tick_host_ms": sorted(host)[len(host) // 2],
            "tick_synced_ms": sorted(synced)[len(synced) // 2],
            "tick_synced_ms_all": synced, "geometry_tables_reused": reused,
            "new_inst_rows": kt1.inst is not kt0.inst,
            "finite": bool(torch.isfinite(img).all())}


def engine_picks(eng, dev) -> dict:
    """Picking on the cell's scene and camera: PICK_POINTS seeded screen
    points through ``raycast(tracer=trace_best)`` (one K2.1 launch) and
    PICK_CALLS single ``Engine.pick`` calls, counts from zero; then the
    raycast against ``trace_brute``, K2.1 at 1, 3 and 33 of those rays
    against its plain version (exact), and single picks through
    ``trace_bvh`` (plain torch) timed."""
    import numpy as np
    import torch

    from clraytracer_tpu_torch.camera import screen_point_to_ray
    from clraytracer_tpu_torch.ops import trace as tr
    from clraytracer_tpu_torch.ops.trace_ref import trace_brute, trace_bvh
    from clraytracer_tpu_torch.raycast import pick, raycast
    from clraytracer_tpu_torch.render import trace_best

    scene, cam = eng.scene, eng.camera
    pts = np.random.default_rng(0).uniform(0, 1, (PICK_POINTS, 2)) * (cam.width, cam.height)
    od = [screen_point_to_ray(cam, float(x), float(y)) for x, y in pts]
    o = torch.from_numpy(np.stack([a for a, _ in od])).to(dev)
    d = torch.from_numpy(np.stack([b for _, b in od])).to(dev)
    raycast(scene, o[:1], d[:1], trace_best)  # tables ready before the count
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    rec = raycast(scene, o, d, trace_best)
    torch.cuda.synchronize()
    batch_ms = (time.perf_counter() - t0) * 1e3
    k21_ms = []
    for x, y in pts[:PICK_CALLS]:
        t0 = time.perf_counter()
        eng.pick(float(x), float(y))
        k21_ms.append((time.perf_counter() - t0) * 1e3)
    launches = read_counts()
    ref = raycast(scene, o, d, trace_brute)
    same = (rec.hit == ref.hit) & (rec.index == ref.index) & (rec.instance == ref.instance)
    bvh_ms = []
    for x, y in pts[:PICK_CALLS]:
        t0 = time.perf_counter()
        pick(scene, cam, float(x), float(y), trace_bvh)
        bvh_ms.append((time.perf_counter() - t0) * 1e3)
    # K2.1 on a pick's few rays: hits first, then misses
    kt = tr.kernel_tables(scene)
    rays = torch.cat([o.T, d.T]).contiguous()
    hit_i, miss_i = rec.hit.nonzero()[:, 0], (~rec.hit).nonzero()[:, 0]
    few = {}
    for n in (1, 3, 33):
        idx = torch.cat([hit_i[: (n + 1) // 2], miss_i[: n // 2]])
        sub = rays[:, idx].contiguous()
        few[str(n)] = compare_trace(tr.trace_cuda(kt, sub), tr.trace_plain(kt, sub))
    k21_ms.sort()
    bvh_ms.sort()
    return {
        "points": PICK_POINTS, "hits": int(rec.hit.sum()), "raycast_ms": batch_ms,
        "launches": launches, "calls": PICK_CALLS,
        "rays_differing_from_brute": int((~same).sum()),
        "pick_k21_ms": k21_ms[len(k21_ms) // 2], "pick_k21_ms_min": k21_ms[0],
        "pick_bvh_ms": bvh_ms[len(bvh_ms) // 2], "pick_bvh_ms_min": bvh_ms[0],
        "k21_few_rays": few,
        "max_abs_err": max(c["max_abs_err"] for c in few.values()),
    }


def bench_rows(w: int, h: int, tmp) -> list:
    """The bench twin's default and ``--grads`` rows at w x h, in process
    (each prints its JSON line)."""
    import json as _json

    from clraytracer_tpu_torch import bench

    rows = []
    for extra in ([], ["--grads", "--iters", "4"]):
        out = f"{tmp}/bench_row.json"
        if bench.main(["--width", str(w), "--height", str(h), *extra, "--out", out]) != 0:
            raise SystemExit("engine cell: the bench twin failed")
        with open(out) as f:
            rows.append(_json.load(f))
    return rows


def live_viewer_run(tmp) -> dict:
    """``tools.live_viewer`` as a process on the card at VIEWER_WH:
    VIEWER_FRAMES frames (each PNG decoded, X-Frame rising), a pick of the
    sphere, a material edit and a frame after it; ms per request on the
    host clock (the HTTP round trip and the PNG encode included)."""
    import os
    import socket
    import urllib.request
    from pathlib import Path

    from clraytracer_tpu_torch.scene.imagefile import decode_image

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    w, h = VIEWER_WH
    root = os.path.dirname(os.path.abspath(__file__))
    t_start = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "clraytracer_tpu_torch.tools.live_viewer", "--scene", "two",
         "--width", str(w), "--height", str(h), "--port", str(port)],
        cwd=root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
    )
    url = f"http://127.0.0.1:{port}"

    def get(path: str):
        t0 = time.perf_counter()
        with urllib.request.urlopen(url + path, timeout=120) as r:
            body, head = r.read(), dict(r.headers)
        return body, head, (time.perf_counter() - t0) * 1e3

    try:
        deadline = time.time() + 180
        while True:
            try:
                get("/")
                break
            except OSError:
                if proc.poll() is not None:
                    raise SystemExit("live viewer died:\n"
                                     + proc.stdout.read().decode(errors="replace")[-2000:])
                if time.time() > deadline:
                    raise SystemExit("live viewer did not come up")
                time.sleep(0.5)
        up_s = time.perf_counter() - t_start
        numbers, frame_ms, shapes = [], [], []
        for i in range(VIEWER_FRAMES):
            body, head, ms = get("/frame?mx=0&my=0&r=0&u=0&f=0")
            p = Path(tmp) / f"viewer_{i}.png"
            p.write_bytes(body)
            shapes.append(list(decode_image(p).shape))
            numbers.append(int(head["X-Frame"]))
            frame_ms.append(ms)
        last = body
        pick_body, _, pick_ms = get(f"/pick?x={VIEWER_PICK[0]}&y={VIEWER_PICK[1]}")
        hit = json.loads(pick_body)
        _, _, edit_ms = get("/material?i=1&c=%230000ff")
        body, head, after_ms = get("/frame?mx=0&my=0&r=0&u=0&f=0")
        mats = json.loads(get("/materials")[0])
    finally:
        proc.terminate()
        proc.wait(timeout=30)
        proc.stdout.close()
    return {
        "size": [w, h], "up_s": up_s, "x_frame": numbers, "frame_ms": frame_ms,
        "png_shapes": shapes, "pick": hit, "pick_ms": pick_ms, "material_ms": edit_ms,
        "frame_after_edit_ms": after_ms, "edit_changed_frame": body != last,
        "material_1": mats[1],
        "ok": (all(s == [h, w, 3] for s in shapes) and numbers == sorted(set(numbers))
               and len(numbers) == VIEWER_FRAMES and hit["hit"] is True
               and hit["instance"] == 0 and body != last and mats[1] == "#0000ff"),
    }


def phase_engine(dev, results) -> None:
    """(u): ``engine.Engine`` on (a)'s scene at 1920x1080 with
    ``tracer="best"`` and the 80 ms watchdog: WARMUP + FRAMES animated
    frames (``engine_step``), counts from zero (one K2.2 launch a frame, no
    K2.1), each frame's ms by CUDA events, its tick's host ms; the host's
    issue of a frame (the watchdog off, the card drained before each); the
    last frame bit-equal to ``render_frame`` on a scene freshly built from
    the builder's state; a 16-row band of that frame's launch against
    ``render_fused_plain``; ticks on (c)'s scene; picking
    (``engine_picks``); the bench twin's rows; the live viewer."""
    import dataclasses
    import tempfile

    import torch

    from clraytracer_tpu_torch.cli import scene_builder
    from clraytracer_tpu_torch.config import CameraConfig, RenderConfig
    from clraytracer_tpu_torch.engine import Engine
    from clraytracer_tpu_torch.ops import render_fused as rf
    from clraytracer_tpu_torch.ops import trace as tr
    from clraytracer_tpu_torch.render import frame_inputs_from_camera, render_frame

    t_phase = time.perf_counter()
    tag, spec, tris, w, h = ENGINE_CELL
    cfg = RenderConfig(width=w, height=h, frame_watchdog_ms=ENGINE_WATCHDOG_MS)
    builder = scene_builder(spec, tris)
    eng = Engine(builder, cfg, CameraConfig(position=CAMERA), tracer="best")
    eng.start()
    # ---- the main path's own run: counts from zero
    reset_counts()
    frame_ms, tick_ms = [], []
    for i in range(WARMUP + FRAMES):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        tick_ms.append(engine_step(eng, i))
        b.record()
        b.synchronize()
        frame_ms.append(a.elapsed_time(b))
    frames = WARMUP + FRAMES
    launches = {"K2.2": rf.render_cuda.launches, "K2.1": tr.trace_cuda.launches,
                "K2.2_variants": dict(rf.render_cuda.variant_launches)}
    steady = sorted(frame_ms[WARMUP:])
    ticks = sorted(tick_ms[WARMUP:])
    # ---- the host's issue of a frame: the watchdog off (it waits for the
    # frame), the card drained before each frame
    eng.config = dataclasses.replace(cfg, frame_watchdog_ms=None)
    issue = []
    for i in range(FRAMES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine_step(eng, frames + i)
        issue.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    eng.config = cfg
    issue.sort()
    # ---- the last frame against a scene built afresh from the builder
    engine_step(eng, frames + FRAMES)
    frame = frame_inputs_from_camera(eng.camera, eng.sun_angle)
    img = eng.render()
    eng.end_frame()
    fresh = builder.build(device=dev)
    ref_img = render_frame(fresh, frame, RenderConfig(width=w, height=h))
    bit_equal = bool(torch.equal(img, ref_img))
    finite = bool(torch.isfinite(img).all())
    del fresh, ref_img
    # ---- a band of the animated frame's launch against its plain version
    args = option_args(eng.scene, frame, w, h, cfg.bounces)
    kt, trows = args[0], args[5]
    out = rf.render_cuda(*args)
    rays, _ = camera_rays(w, h, dev, frame)
    hit0 = tr.trace_cuda(kt, rays)[0].abs() < tr.BIG
    y0 = band_start(hit0, w, h, trows, CHECK_BAND_ROWS)
    band = band_index(w, trows, y0, CHECK_BAND_ROWS, dev)
    band_check = compare_options(
        out[:, band], rf.render_fused_plain(*band_args(args, y0, CHECK_BAND_ROWS), dev), 0, False)
    band_hits = int(hit0[band].sum())
    del out, rays
    large = engine_ticks_large(dev, w, h)
    picks = engine_picks(eng, dev)
    with tempfile.TemporaryDirectory() as tmp:
        rows = bench_rows(w, h, tmp)
        viewer = live_viewer_run(tmp)
    line = {
        "phase": "engine", "config": tag, "scene": spec,
        "triangles": int(eng.scene.tris.count), "width": w, "height": h,
        "bounces": cfg.bounces, "tracer": eng.tracer, "watchdog_ms": ENGINE_WATCHDOG_MS,
        "frames": frames, "frame_ms": steady[len(steady) // 2], "frame_ms_min": steady[0],
        "frame_ms_max": steady[-1], "frame_ms_first": frame_ms[:WARMUP],
        "frame_host_ms": issue[len(issue) // 2],
        "tick_ms": ticks[len(ticks) // 2], "tick_ms_max": ticks[-1],
        "launches": launches, "k22_launches_per_frame": launches["K2.2"] / frames,
        "last_frame_bit_equal_fresh_build": bit_equal, "finite": finite,
        "band_check": {"frame": f"{w}x{CHECK_BAND_ROWS} band (rows {y0}-"
                       f"{y0 + CHECK_BAND_ROWS - 1}) of {w}x{h}", "band_hits": band_hits,
                       **band_check},
        "ticks_large": large, "picks": picks, "bench_rows": rows, "live_viewer": viewer,
    }
    line["phase_s"] = time.perf_counter() - t_phase
    line["ok"] = (
        finite and bit_equal and band_check["ok"] and band_hits > 0
        and launches["K2.2"] == frames and launches["K2.1"] == 0
        and launches["K2.2_variants"] == {"default": frames}
        and large["geometry_tables_reused"] and large["new_inst_rows"] and large["finite"]
        and picks["launches"]["K2.1"] == 1 + PICK_CALLS and picks["launches"]["K2.2"] == 0
        and picks["hits"] > 0 and picks["rays_differing_from_brute"] <= FRAME_MISMATCH_MAX
        and all(c["ok"] and c["rays_not_exact"] == 0 for c in picks["k21_few_rays"].values())
        and len(rows) == 2 and all(r["value"] > 0 for r in rows) and viewer["ok"]
    )
    results["engine"] = line
    results["trace_err"] = max(results["trace_err"], picks["max_abs_err"])
    results["fused_err"] = max(results["fused_err"], band_check["max_abs_err_within"])
    emit(line)
    if not line["ok"]:
        raise SystemExit("engine cell (u) failed")


# ---------------------------------------------------------------------------
# (v) the multi-device layer: parallel.sharding and parallel.geometry over
# torch.distributed, one rank in process on NCCL and 2 or 4 gloo ranks
# sharing the card
# ---------------------------------------------------------------------------

SHARD_CELL = ("v", "sphere", 4096, 1920, 1080)
SHARD_UNEVEN_WH = (320, 239)  # 2 windows of 120 rows: the last runs past H
SHARD_TWO_PHASE = ("sphere65", 4096, 1920, 1080)
SHARD_TWO_PHASE_FRAMES = 5
SHARD_GEO_WH = (320, 240)  # cut: the geo tracer is the plain-torch wavefront walk
SHARD_GEO_MESH = (2, 2)  # rows x instance blocks
SHARD_GEO_RAYS = 4096
SHARD_GEO_CAMERA = (0.17, 0.23, 7.0)  # tests/test_geometry_sharding.py:54
SHARD_LR = 1.0
SWEEP_ITERS = 10
#: seconds a world of ranks may take (start-up, kernel load, scene build
#: and work), and the timeout of each rank's process group
RANK_TIMEOUT_S = 240


def geo_scene(device):
    """tests/test_geometry_sharding.py:34-49's 5-instance scene (a sphere and
    cubes, overlapping), built with the port's builder."""
    from clraytracer_tpu_torch import math3d
    from clraytracer_tpu_torch.scene import SceneBuilder
    from clraytracer_tpu_torch.scene import procedural_tex as ptex
    from clraytracer_tpu_torch.scene.procedural import cube, uv_sphere

    b = SceneBuilder()
    b.import_procedural(ptex.sky_gradient(32, 16))
    checker = b.import_procedural(ptex.checker(16, 4))
    m0 = b.create_material(albedo=(0.9, 0.3, 0.2), albedo_tex=checker)
    m1 = b.create_material(albedo=(0.2, 0.8, 0.3), shininess=1.5)
    sphere = b.add_mesh(uv_sphere(1.0, n_lat=6, n_lon=10), materials_start=m0)
    cube_m = b.add_mesh(cube(0.9), materials_start=m1)
    b.add_instance(sphere)
    b.add_instance(cube_m, math3d.translation(1.2, 0.1, -0.5))
    b.add_instance(cube_m, math3d.translation(-1.4, -0.2, 0.6))
    b.add_instance(sphere, math3d.translation(0.6, 0.9, -1.0))
    b.add_instance(cube_m, math3d.translation(-0.3, -1.0, -0.2))
    return b.build(device=device)


def geo_inputs(dev):
    """(frame at SHARD_GEO_WH, planar rays [3, n] origins and directions of
    SHARD_GEO_RAYS pixels drawn with numpy's generator from seed 0)."""
    import numpy as np
    import torch

    from clraytracer_tpu_torch.camera import Camera, ray_directions_planar
    from clraytracer_tpu_torch.config import CameraConfig
    from clraytracer_tpu_torch.render import frame_inputs_from_camera

    w, h = SHARD_GEO_WH
    cam = Camera.create(CameraConfig(position=SHARD_GEO_CAMERA), w, h)
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32).to(dev)
    d = ray_directions_planar(f32(cam.inverse_view), f32(cam.inverse_projection), w, h)
    pick = np.random.default_rng(0).choice(w * h, SHARD_GEO_RAYS, replace=False)
    d = d.reshape(3, -1)[:, torch.from_numpy(pick).to(dev)]
    o = f32(cam.position)[:, None].expand_as(d)
    return frame_inputs_from_camera(cam, -1.8), o, d


def step_target(h: int, w: int, dev):
    import numpy as np
    import torch

    noise = np.random.default_rng(0).uniform(0.0, 1.0, (h, w, 3)).astype(np.float32)
    return torch.from_numpy(noise).to(dev)


def sharded_render(mesh, scene, frame, w: int, h: int, frames: int, warmup: int) -> dict:
    """``render_sharded`` on this rank: counts from zero over warmup +
    frames frames (the main path's own run), frame ms by CUDA events (the
    gather included; every rank times its own), the all-gather of the
    window alone, and the frame."""
    import torch

    from clraytracer_tpu_torch.config import RenderConfig
    from clraytracer_tpu_torch.parallel import sharding as sh

    cfg = RenderConfig(width=w, height=h)
    run = lambda: sh.render_sharded(scene, frame, cfg, mesh)
    run()  # tables upload
    torch.cuda.synchronize()
    reset_counts()
    ms, times = event_ms(run, frames, warmup)
    launches = read_counts()
    img = run()
    local_rows = -(-h // mesh.size)
    block = torch.zeros(local_rows, w, 3, device=mesh.device)
    gather_ms, _ = event_ms(lambda: sh._all_gather_rows(mesh, block), frames, warmup)
    torch.cuda.synchronize()
    return {"frame_ms": ms, "frame_ms_min": times[0], "frame_ms_max": times[-1],
            "frames": frames + warmup, "launches": launches, "gather_ms": gather_ms,
            "gather_bytes": block.numel() * 4 * mesh.size, "img": img.cpu()}


def sharded_step(mesh, scene, frame, target, w: int, h: int) -> dict:
    """``train_step_sharded`` on this rank at (e)'s configuration: counts
    from zero over STEP_WARMUP + STEPS steps, step ms by CUDA events, the
    all-reduce of [loss, gradients] alone, the loss and the new albedo."""
    import torch

    from clraytracer_tpu_torch.diff import DIFF_GROUPS, _float_leaves
    from clraytracer_tpu_torch.parallel import sharding as sh

    run = lambda: sh.train_step_sharded(scene, frame, target, mesh, lr=SHARD_LR)
    run()
    torch.cuda.synchronize()
    reset_counts()
    ms, times = event_ms(run, STEPS, STEP_WARMUP)
    launches = read_counts()
    loss, new = run()
    n = 1 + sum(v.numel() for g, _f, v in _float_leaves(scene) if g in DIFF_GROUPS)
    flat = torch.zeros(n, device=mesh.device)
    reduce_ms, _ = event_ms(lambda: sh._all_reduce(mesh, flat), STEPS, STEP_WARMUP)
    torch.cuda.synchronize()
    return {"step_ms": ms, "step_ms_min": times[0], "step_ms_max": times[-1],
            "steps": STEPS + STEP_WARMUP, "launches": launches, "allreduce_ms": reduce_ms,
            "allreduce_bytes": n * 4, "loss": float(loss),
            "albedo": new.materials.albedo.cpu()}


def sharded_world_work(mesh, dev) -> dict:
    """(v1)-(v4) on this rank of ``mesh``: (a) at 1080p, the uneven frame,
    sphere65's two-phase rows, (e)'s step."""
    from clraytracer_tpu_torch.cli import build_scene
    from clraytracer_tpu_torch.parallel.sharding import replicate_scene

    _tag, spec, tris, w, h = SHARD_CELL
    scene = replicate_scene(build_scene(spec, tris, device=dev), mesh)
    out = {"v1": sharded_render(mesh, scene, diff_frame(w, h, dev), w, h, FRAMES, WARMUP)}
    uw, uh = SHARD_UNEVEN_WH
    out["v2"] = sharded_render(mesh, scene, diff_frame(uw, uh, dev), uw, uh, 3, 1)
    out["v4"] = sharded_step(mesh, scene, diff_frame(w, h, dev), step_target(h, w, dev), w, h)
    spec3, tris3, w3, h3 = SHARD_TWO_PHASE
    scene3 = replicate_scene(option_scene(spec3, tris3, device=dev), mesh)
    out["v3"] = sharded_render(mesh, scene3, diff_frame(w3, h3, dev), w3, h3,
                               SHARD_TWO_PHASE_FRAMES, 1)
    return out


def geo_world_work(dev) -> dict:
    """(v5) on this rank of 4: ``render_sharded_2d`` on the 2x2 mesh and the
    geo tracer over all 4 ranks on the seeded rays, counts from zero."""
    import torch

    from clraytracer_tpu_torch.config import RenderConfig
    from clraytracer_tpu_torch.parallel import geometry as geo
    from clraytracer_tpu_torch.parallel.sharding import make_device_mesh, replicate_scene

    mesh2 = geo.make_mesh_2d(*SHARD_GEO_MESH, device=dev)
    mesh1 = make_device_mesh(device=dev)
    scene = replicate_scene(geo_scene(dev), mesh1)
    frame, o, d = geo_inputs(dev)
    w, h = SHARD_GEO_WH
    reset_counts()
    t0 = time.perf_counter()
    img = geo.render_sharded_2d(scene, frame, RenderConfig(width=w, height=h), mesh2)
    torch.cuda.synchronize()
    frame_s = time.perf_counter() - t0
    hit = geo.make_geo_sharded_tracer(mesh1)(scene, o, d)
    torch.cuda.synchronize()
    return {"img": img.cpu(), "frame_s": frame_s, "launches": read_counts(),
            "hit": {f: getattr(hit, f).cpu() for f in ("t", "u", "v", "tri", "instance",
                                                          "hit")}}


def sharded_rank(rank: int, world: int, tmp: str, device: str = "cuda") -> None:
    """One gloo rank on the card (started by ``run_world``): its process
    group with a timeout, the kernels loaded from the parent's build, then
    (v1)-(v4) in a world of 2 or (v5) in a world of 4; what it got goes to
    ``<tmp>/rank<r>_of<world>.pt``."""
    import datetime

    import torch
    import torch.distributed as dist

    from clraytracer_tpu_torch.parallel.sharding import make_device_mesh
    from clraytracer_tpu_torch.runtime import kernels

    dev = torch.device(device, 0) if device == "cuda" else torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rdv{world}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))
    if dev.type == "cuda":
        kernels.build_all()
    if world == 2:
        out = sharded_world_work(make_device_mesh(device=dev), dev)
    else:
        out = geo_world_work(dev)
    dist.barrier()
    dist.destroy_process_group()
    torch.save(out, f"{tmp}/rank{rank}_of{world}.pt")


def run_world(world: int, tmp: str, device: str = "cuda") -> list:
    """``world`` gloo ranks (``sharded_rank``) started with
    torch.multiprocessing; fails the phase if a rank exits non-zero or the
    world outlasts RANK_TIMEOUT_S (the others are killed). Returns each
    rank's results."""
    import torch
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=sharded_rank, args=(r, world, tmp, device))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.time() + RANK_TIMEOUT_S
    try:
        while any(p.is_alive() for p in procs):
            bad = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
            if bad or time.time() > deadline:
                raise SystemExit(f"sharded: a rank of {world} failed (exit codes "
                                 f"{[p.exitcode for p in procs]}) or hung")
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(30)
    codes = [p.exitcode for p in procs]
    if any(c != 0 for c in codes):
        raise SystemExit(f"sharded: ranks of {world} exited with {codes}")
    return [torch.load(f"{tmp}/rank{r}_of{world}.pt") for r in range(world)]


def frame_mismatch(img, ref) -> int:
    """Pixels with a channel more than 1e-5 from ``ref``."""
    return int(((img - ref.cpu()).abs() > 1e-5).any(dim=-1).sum())


def sweep_rows(argv: list) -> list:
    """``cli sweep`` in process: its JSON lines."""
    import contextlib
    import io

    from clraytracer_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        if cli.main(argv) != 0:
            raise SystemExit("sharded: cli sweep failed")
    return [json.loads(x) for x in buf.getvalue().splitlines() if x.startswith("{")]


def sweep_processes(argv: list, world: int) -> list:
    """``python -m clraytracer_tpu_torch sweep`` as ``world`` processes on the
    card: rank 0's JSON lines."""
    import os

    root = os.path.dirname(os.path.abspath(__file__))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "clraytracer_tpu_torch", *argv, "--num-processes",
         str(world), "--process-id", str(r)],
        cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=RANK_TIMEOUT_S)
            if p.returncode != 0:
                raise SystemExit(f"sharded: sweep rank exited {p.returncode}:\n{err[-2000:]}")
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return [json.loads(x) for x in outs[0].splitlines() if x.startswith("{")]


def sharded_kernel_checks(dev, results) -> dict:
    """The kernels of (v) against their plain versions at the path's shapes
    (the last rank's window of the 2-rank frames), timed, with bounds: K2.2
    on (v1)'s row window from row 540 (past nothing, 1080 = 2 x 540) and on
    (v2)'s window past H; K2.1 on (v3)'s window of camera rays; K2.3 and
    K2.4 on the last rank's own step (its rows, before its all-reduce)."""
    import torch

    from clraytracer_tpu_torch.camera import ray_directions_planar
    from clraytracer_tpu_torch.cli import build_scene
    from clraytracer_tpu_torch.ops import gather_rows as gr
    from clraytracer_tpu_torch.ops import render_fused as rf
    from clraytracer_tpu_torch.ops import trace as tr
    from clraytracer_tpu_torch.parallel import sharding as sh

    _tag, spec, tris, w, h = SHARD_CELL
    scene = build_scene(spec, tris, device=dev)
    kt, ft = tr.kernel_tables(scene), rf.frame_tables(scene)
    out = {}

    def window_rays(frame, w, h, row0, rows):
        d = ray_directions_planar(frame.inverse_view, frame.inverse_projection, w, h,
                                  row_start=row0, num_rows=rows).reshape(3, -1)
        return torch.cat([frame.camera_position[:, None].expand_as(d), d]).contiguous()

    def k22_window(w, h, tag):
        frame = diff_frame(w, h, dev)
        rows = -(-h // 2)
        trows = rf.tile_rows(w * rows)
        rows_total = -(-rows // trows) * -(-w // 128) * trows
        args = (kt, ft, rf.camera_row(frame, rows), w, h, trows, rows_total, 2)
        cnt = torch.zeros(6, dtype=torch.int64, device=dev)
        got = rf.render_cuda(*args, cnt)
        ref = rf.render_fused_plain(*args, dev)
        torch.cuda.synchronize()
        check = compare_options(got, ref, 0, False)
        k1 = tr.trace_cuda(kt, window_rays(frame, w, h, rows, rows))
        clusters, slots = winners(k1)
        kb = walk_bound(("K2.2", tag, int(scene.tris.count)),
                        walk_bytes(kt, clusters, slots, ft) + 9 * rows_total * 128 * 4,
                        cnt.cpu().tolist(), rows_total * 128, shade=True)
        ms, _ = event_ms(lambda: rf.render_cuda(*args), 10, 2)
        return {"window": f"rows {rows}-{2 * rows - 1} of {w}x{h}", "check": check,
                "ms": ms, "device_ms": device_ms(lambda: rf.render_cuda(*args)),
                "plain_ms": event_ms(lambda: rf.render_fused_plain(*args, dev), 1, 0)[0],
                **kb}

    out["K2.2"] = k22_window(w, h, "v1")
    out["K2.2_uneven"] = k22_window(*SHARD_UNEVEN_WH, "v2")
    del kt, ft
    # ---- K2.1 on (v3)'s last window of camera rays, sphere65
    spec3, tris3, w3, h3 = SHARD_TWO_PHASE
    scene3 = option_scene(spec3, tris3, device=dev)
    kt3 = tr.kernel_tables(scene3)
    rows = -(-h3 // 2)
    rays = window_rays(diff_frame(w3, h3, dev), w3, h3, rows, rows)
    n = rays.shape[1]
    cnt = torch.zeros(6, dtype=torch.int64, device=dev)
    got = tr.trace_cuda(kt3, rays, None, cnt)
    ref = tr.trace_plain(kt3, rays)
    torch.cuda.synchronize()
    clusters, slots = winners(got)
    kb = walk_bound(("K2.1", "v3", int(scene3.tris.count)),
                    6 * n * 4 + walk_bytes(kt3, clusters, slots) + 11 * n * 4,
                    cnt.cpu().tolist())
    out["K2.1"] = {"window": f"rows {rows}-{2 * rows - 1} of {w3}x{h3}, {spec3}",
                   "check": compare_trace(got, ref),
                   "ms": event_ms(lambda: tr.trace_cuda(kt3, rays), 10, 2)[0],
                   "device_ms": device_ms(lambda: tr.trace_cuda(kt3, rays)),
                   "plain_ms": event_ms(lambda: tr.trace_plain(kt3, rays), 1, 0)[0], **kb}
    del got, ref, kt3
    # ---- K2.3 and K2.4 on the last rank's own step: a mesh of 2 seen from
    # rank 1 without a group runs that rank's rows, and no all-reduce
    gathers, scatters = [], []
    real_gather, real_scatter = gr.gather_rows, gr.scatter_rows

    def rec_gather(table, idx):
        gathers.append((table.detach(), idx))
        return real_gather(table, idx)

    def rec_scatter(g, idx, t_rows):
        scatters.append((g, idx, t_rows))
        return real_scatter(g, idx, t_rows)

    last = sh.DeviceMesh(None, 1, 2, dev)
    gr.gather_rows, gr.scatter_rows = rec_gather, rec_scatter
    try:
        sh.train_step_sharded(scene, diff_frame(w, h, dev), step_target(h, w, dev), last,
                              lr=SHARD_LR)
        torch.cuda.synchronize()
    finally:
        gr.gather_rows, gr.scatter_rows = real_gather, real_scatter
    out["gather"] = check_gather_kernels(gathers, scatters)
    return out


def phase_sharded(dev, results) -> None:
    """(v): the multi-device layer. (v1)-(v4) in process as a 1-rank NCCL
    group (``sharded_world_work``), then as 2 gloo ranks on the one card
    (``run_world``), (v5) as 4 gloo ranks (a 2x2 mesh), (v6) ``cli sweep`` in
    process (1 rank, NCCL) and as 2 gloo processes; checks against
    ``render_frame`` and ``image_loss_and_grads`` on the same inputs; the
    kernels of the path against their plain versions
    (``sharded_kernel_checks``)."""
    import datetime
    import tempfile

    import torch
    import torch.distributed as dist

    from clraytracer_tpu_torch.cli import build_scene
    from clraytracer_tpu_torch.config import RenderConfig
    from clraytracer_tpu_torch.diff import image_loss_and_grads
    from clraytracer_tpu_torch.ops.trace_wavefront import trace_wavefront
    from clraytracer_tpu_torch.parallel.sharding import make_device_mesh, render_sharded
    from clraytracer_tpu_torch.render import render_frame

    t_phase = time.perf_counter()
    _tag, spec, tris, w, h = SHARD_CELL
    with tempfile.TemporaryDirectory() as tmp:
        # ---- one rank in process: NCCL's init, all-gather and all-reduce
        dist.init_process_group("nccl", init_method=f"file://{tmp}/nccl", world_size=1,
                                rank=0, timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S),
                                device_id=dev)
        mesh = make_device_mesh()
        one = sharded_world_work(mesh, dev)
        # (v1) the sharded frame and render_frame in turns
        scene = build_scene(spec, tris, device=dev)
        frame = diff_frame(w, h, dev)
        cfg = RenderConfig(width=w, height=h)
        turns = {"render_sharded": [], "render_frame": []}
        fns = {"render_sharded": lambda: render_sharded(scene, frame, cfg, mesh),
               "render_frame": lambda: render_frame(scene, frame, cfg)}
        for i in range(WARMUP + FRAMES):
            for k, fn in fns.items():
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                fn()
                b.record()
                b.synchronize()
                if i >= WARMUP:
                    turns[k].append(a.elapsed_time(b))
        turns = {k: sorted(v)[len(v) // 2] for k, v in turns.items()}
        dist.destroy_process_group()
        ref1 = render_frame(scene, frame, cfg).cpu()
        uw, uh = SHARD_UNEVEN_WH
        ref2 = render_frame(scene, diff_frame(uw, uh, dev), RenderConfig(width=uw, height=uh))
        spec3, tris3, w3, h3 = SHARD_TWO_PHASE
        scene3 = option_scene(spec3, tris3, device=dev)
        reset_counts()
        ref3 = render_frame(scene3, diff_frame(w3, h3, dev), RenderConfig(width=w3, height=h3))
        ref3_launches = read_counts()
        target = step_target(h, w, dev)
        loss_ref, g_ref = image_loss_and_grads(scene, frame, w, h, target=target)
        g_ref = g_ref["materials.albedo"].cpu() * (h * w * 3)
        del scene3
        # ---- 2 gloo ranks on the card
        t0 = time.perf_counter()
        two = run_world(2, tmp)
        world2_s = time.perf_counter() - t0
        # ---- (v5) 4 gloo ranks: a 2x2 mesh of rows and instance blocks
        t0 = time.perf_counter()
        four = run_world(4, tmp)
        world4_s = time.perf_counter() - t0
        gs = geo_scene(dev)
        gframe, go, gd = geo_inputs(dev)
        gw, gh = SHARD_GEO_WH
        ref5 = render_frame(gs, gframe, RenderConfig(width=gw, height=gh),
                            tracer=trace_wavefront).cpu()
        hit5 = trace_wavefront(gs, go, gd)
        # ---- (v6) cli sweep: 1 rank in process on NCCL, then 2 gloo processes
        sweep_argv = ["sweep", "--scene", spec, "--tris", str(tris), "--width", str(w),
                      "--height", str(h), "--iters", str(SWEEP_ITERS)]
        sweep1 = sweep_rows(sweep_argv + ["--coordinator", f"file://{tmp}/cli1",
                                          "--num-processes", "1", "--process-id", "0"])
        sweep2 = sweep_processes(sweep_argv + ["--backend", "gloo", "--coordinator",
                                               f"file://{tmp}/cli2"], 2)
    body = {}
    ok = True
    # (v1), (v2), (v3): per rank and frame, one K2.2 launch (v1, v2) or one
    # K2.1 launch a bounce (v3); every rank's frame bit-equal to the 1-rank
    # frame; the frames against render_frame
    per_frame = {"v1": {"K2.1": 0, "K2.2": 1, "K2.3": 0, "K2.4": 0},
                 "v2": {"K2.1": 0, "K2.2": 1, "K2.3": 0, "K2.4": 0},
                 "v3": {"K2.1": 2, "K2.2": 0, "K2.3": 0, "K2.4": 0}}
    refs = {"v1": ref1, "v2": ref2.cpu(), "v3": ref3.cpu()}
    for key in ("v1", "v2", "v3"):
        runs = [one[key]] + [r[key] for r in two]
        want = [{k: v * r["frames"] for k, v in per_frame[key].items()} for r in runs]
        c = {
            "nccl_1_rank": {k: one[key][k] for k in ("frame_ms", "frame_ms_min",
                                                      "frame_ms_max", "gather_ms",
                                                      "gather_bytes", "launches", "frames")},
            "gloo_2_ranks": [{k: r[key][k] for k in ("frame_ms", "frame_ms_min",
                                                      "frame_ms_max", "gather_ms",
                                                      "gather_bytes", "launches", "frames")}
                             for r in two],
            "ranks_bit_equal_1_rank": [bool(torch.equal(r[key]["img"], one[key]["img"]))
                                       for r in two],
            "pixels_over_1e-5_vs_render_frame": frame_mismatch(one[key]["img"], refs[key]),
            "finite": bool(torch.isfinite(one[key]["img"]).all()),
            "launches_ok": [r["launches"] == x for r, x in zip(runs, want)],
        }
        c["ok"] = (all(c["ranks_bit_equal_1_rank"]) and all(c["launches_ok"]) and c["finite"]
                   and c["pixels_over_1e-5_vs_render_frame"] <= FRAME_MISMATCH_MAX)
        body[key] = c
        ok = ok and c["ok"]
    body["v1"]["frame_ms_in_turns"] = turns
    body["v2"]["frame"] = f"{uw}x{uh}, windows of {-(-uh // 2)} rows (the last past H)"
    body["v3"]["render_frame_launches"] = ref3_launches
    # (v4): loss and albedo of 2 ranks against 1; the implied gradient
    # against image_loss_and_grads
    v4 = [one["v4"]] + [r["v4"] for r in two]
    steps = one["v4"]["steps"]
    want4 = {"K2.1": 2 * steps, "K2.2": 0, "K2.3": 2 * steps, "K2.4": 2 * steps}
    albedo0 = scene.materials.albedo.cpu()
    implied = (albedo0 - one["v4"]["albedo"]) / (SHARD_LR / (h * w * 3))
    grad_err = (implied - g_ref).abs() - (2e-2 * g_ref.abs() + 1e-5)
    c = {
        "nccl_1_rank": {k: one["v4"][k] for k in ("step_ms", "step_ms_min", "step_ms_max",
                                                   "allreduce_ms", "allreduce_bytes",
                                                   "launches", "steps", "loss")},
        "gloo_2_ranks": [{k: r["v4"][k] for k in ("step_ms", "step_ms_min", "step_ms_max",
                                                   "allreduce_ms", "allreduce_bytes",
                                                   "launches", "steps", "loss")}
                         for r in two],
        "loss_image_loss_and_grads": float(loss_ref),
        "loss_rel_err_2_vs_1": max(abs(r["loss"] - one["v4"]["loss"]) / abs(one["v4"]["loss"])
                                   for r in v4[1:]),
        "albedo_2_vs_1_within_rtol_1e-4": all(
            bool(torch.allclose(r["albedo"], one["v4"]["albedo"], rtol=1e-4, atol=0.0))
            for r in v4[1:]),
        "grad_vs_image_loss_and_grads_ok": bool((grad_err <= 0).all()),
        "grad_max_abs": float(g_ref.abs().max()),
        "launches_ok": [r["launches"] == want4 for r in v4],
    }
    c["ok"] = (c["loss_rel_err_2_vs_1"] <= 1e-4 and c["albedo_2_vs_1_within_rtol_1e-4"]
               and c["grad_vs_image_loss_and_grads_ok"] and c["grad_max_abs"] > 0
               and all(c["launches_ok"])
               and abs(one["v4"]["loss"] - float(loss_ref)) <= 2e-2 * abs(float(loss_ref)))
    body["v4"] = c
    ok = ok and c["ok"]
    # (v5): every rank's frame bit-equal to render_frame(trace_wavefront);
    # the geo tracer's records equal to trace_wavefront's; no kernel
    hits_equal = [all(bool(torch.equal(r["hit"][f], getattr(hit5, f).cpu()))
                      for f in r["hit"]) for r in four]
    c = {
        "mesh": list(SHARD_GEO_MESH), "frame": f"{gw}x{gh}", "rays": SHARD_GEO_RAYS,
        "instances": int(gs.instances.count), "world_s": world4_s,
        "frame_s": [r["frame_s"] for r in four],
        "ranks_bit_equal_render_frame": [bool(torch.equal(r["img"], ref5)) for r in four],
        "pixels_differing": [int((r["img"] != ref5).any(dim=-1).sum()) for r in four],
        "hits_equal_trace_wavefront": hits_equal,
        "hits": int(hit5.hit.sum()),
        "launches": [r["launches"] for r in four],
    }
    c["ok"] = (all(c["ranks_bit_equal_render_frame"]) and all(hits_equal) and c["hits"] > 0
               and all(sum(x.values()) == 0 for x in c["launches"]))
    body["v5"] = c
    ok = ok and c["ok"]
    # (v6)
    c = {"nccl_1_rank": sweep1, "gloo_2_processes": sweep2,
         "note": "2 ranks share one card: a mechanism check, not scaling"}
    c["ok"] = (len(sweep1) == 2 and sweep1[0]["devices"] == 1
               and sweep1[0]["efficiency"] == 1.0 and sweep1[-1]["backend"] == "nccl"
               and len(sweep2) == 3 and [r["devices"] for r in sweep2[:2]] == [1, 2]
               and sweep2[-1]["backend"] == "gloo"
               and all(r["mrays_per_s"] > 0 for r in sweep1[:1] + sweep2[:2]))
    body["v6"] = c
    ok = ok and c["ok"]
    kern = sharded_kernel_checks(dev, results)
    ok = ok and all(kern[k]["check"]["ok"] for k in ("K2.2", "K2.2_uneven", "K2.1"))
    ok = ok and kern["gather"]["K2.3"]["ok"] and kern["gather"]["K2.4"]["ok"]
    line = {"phase": "sharded", "config": "v", "scene": spec,
            "triangles": int(scene.tris.count), "width": w, "height": h,
            "card": card_line(), "world2_s": world2_s, **body,
            "kernels": {k: {x: y for x, y in v.items() if x != "cases"}
                        if k == "gather" else v for k, v in kern.items()},
            "phase_s": time.perf_counter() - t_phase, "ok": ok}
    results["sharded"] = {"line": line, "kern": kern, "launches": {
        "K2.2": sum(r[k]["launches"]["K2.2"] for r in [one] + two for k in ("v1", "v2")),
        "K2.1": sum(r[k]["launches"]["K2.1"] for r in [one] + two for k in ("v3", "v4")),
        "K2.3": sum(r["v4"]["launches"]["K2.3"] for r in [one] + two),
        "K2.4": sum(r["v4"]["launches"]["K2.4"] for r in [one] + two)}}
    results["fused_err"] = max(results["fused_err"], kern["K2.2"]["check"]["max_abs_err_within"],
                               kern["K2.2_uneven"]["check"]["max_abs_err_within"])
    results["trace_err"] = max(results["trace_err"], kern["K2.1"]["check"]["max_abs_err"])
    emit(line)
    if not ok:
        raise SystemExit("sharded cell (v) failed")


def sharded_kernel_entries(results) -> list:
    """The kernels-line entries of (v): K2.2 on the row windows of (v1) and
    (v2), K2.1 on (v3)'s and (v4)'s sharded rows, K2.3 and K2.4 in (v4)'s
    step; launches summed over the 1-rank and the 2-rank runs, ms, plain
    ms and bounds at the last rank's shapes (``sharded_kernel_checks``)."""
    v, kern = results["sharded"], results["sharded"]["kern"]
    line, launches = v["line"], v["launches"]
    k22, k22u, k21 = kern["K2.2"], kern["K2.2_uneven"], kern["K2.1"]
    out = [
        {
            "name": "K2.2 fused frame, row window", "route": "cuda",
            "source": "clraytracer_tpu_torch/csrc/render.cu",
            "replaces": "clraytracer_tpu/ops/render_pallas.py:109",
            "entry": ("render_fused_camera(row0=, local_height=) "
                      "(clraytracer_tpu/ops/render_pallas.py:1204, :1213-1231)"),
            "launches": launches["K2.2"],
            "path": (f"(v1) parallel.render_sharded, {line['width']}x{line['height']}, and "
                     f"(v2) {SHARD_UNEVEN_WH[0]}x{SHARD_UNEVEN_WH[1]}, on 1 NCCL rank and "
                     "2 gloo ranks"),
            "max_abs_err": max(k22["check"]["max_abs_err_all"],
                               k22u["check"]["max_abs_err_all"]),
            "tolerance": f"<= {FRAME_MISMATCH_MAX} rays over 1e-5 on any of nine planes",
            "ms": k22["ms"], "device_ms": k22["device_ms"], "plain_ms": k22["plain_ms"],
            "bound_ms": k22["bound_ms"], "bound_by": k22["bound_by"], "library_ms": None,
            "shape": f"{k22['window']}, 2 bounces",
        },
        {
            "name": "K2.1 trace, sharded rows", "route": "cuda",
            "source": "clraytracer_tpu_torch/csrc/trace.cu",
            "replaces": "clraytracer_tpu/ops/trace_pallas.py:928",
            "launches": launches["K2.1"],
            "path": ("(v3) parallel.render_sharded, two-phase rows of sphere65; (v4) "
                     "parallel.train_step_sharded's hit-finder"),
            "max_abs_err": k21["check"]["max_abs_err"],
            "tolerance": (f"hit rule of tests/test_trace.py; <= {FRAME_MISMATCH_MAX} "
                          "rays not exact in (t, slot, instance); attrs rtol 1e-5 atol 1e-6"),
            "ms": k21["ms"], "device_ms": k21["device_ms"], "plain_ms": k21["plain_ms"],
            "bound_ms": k21["bound_ms"], "bound_by": k21["bound_by"], "library_ms": None,
            "shape": f"{k21['window']} camera rays",
        },
    ]
    for key, name, src, fn in (
        ("K2.3", "K2.3 gather rows (sharded step)", "clrt_gather_rows",
         "clraytracer_tpu/ops/gather_pallas.py:77"),
        ("K2.4", "K2.4 scatter rows (sharded step)", "clrt_scatter_rows",
         "clraytracer_tpu/ops/gather_pallas.py:110"),
    ):
        k = kern["gather"][key]
        out.append({
            "name": name, "route": "cuda",
            "source": "clraytracer_tpu_torch/csrc/gather.cu",
            "entry": src, "replaces": fn, "launches": launches[key],
            "path": f"(v4) parallel.train_step_sharded, {line['width']}x{line['height']}x2",
            "max_abs_err": max(c["max_abs_err"] for c in k["cases"]),
            "tolerance": ("bit-exact" if key == "K2.3"
                          else "1e-5 * sum|g| (plain scatter of |g|) + 1e-7"),
            "ms": k["ms"], "device_ms": k["device_ms"], "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "library_ms": k["library_ms"], "library_device_ms": k["library_device_ms"],
            "shape": f"the last of 2 ranks: {k['shape']}",
        })
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None, help="also write every line here (JSON)")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    try:
        from clraytracer_tpu_torch.runtime import kernels
    except ImportError as exc:
        print(f"chip_smoke: the package is missing ({exc})", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    results: dict = {}
    card = card_line()
    t0 = time.perf_counter()
    kernels.build_all()
    build_s = time.perf_counter() - t0
    regs = {src: ptxas_summary(log) for src, log in kernels.build_log.items()}
    results["ptxas"] = regs
    # K2.2's default instantiation (atlas mode 0, no GI, no shadows)
    k22_default = [e for e in regs.get("render.cu", [])
                   if "render_kernelILi0ELb0ELb0ELi0EE" in e["kernel"]]

    emit({
        "phase": "device", "card": card, "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(), "torch": torch.__version__,
        "cuda": torch.version.cuda, "python": sys.version.split()[0],
        "kernel_build_s": build_s, "ptxas": regs, "k22_default": k22_default,
        "k22_instantiations": k22_registers(regs.get("render.cu", [])),
    })
    phase_trace(dev, results)
    phase_fused(dev, results)
    phase_options(dev, results)
    phase_main(dev, results, TRIS_LARGE)
    phase_option_cells(dev, results)
    phase_twophase_cells(dev, results)
    phase_ray_cell(dev, results)
    phase_split_cell(dev, results)
    phase_imported(dev, results)
    phase_engine(dev, results)
    phase_profile(dev, results)
    phase_diff(dev, results)
    phase_sharded(dev, results)
    phase_kernels(dev, results)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, **results}, f, indent=1, default=str)
    print(card_line(), flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
