"""The CUDA kernels of clraytracer_tpu_torch against their plain PyTorch
versions on the card, and the wrappers' refusal of what they do not take.

Imports neither JAX nor the JAX package, so it also runs on a machine
without them:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

The tests marked ``cuda`` need an NVIDIA card (the kernels have no CPU
build) and skip without one. The option scenes and the plane comparison
are chip_smoke.py's.
"""

import pytest
import torch

from clraytracer_tpu_torch import render as trender
from clraytracer_tpu_torch.camera import Camera
from clraytracer_tpu_torch.cli import build_scene
from clraytracer_tpu_torch.config import CameraConfig, RenderConfig
from clraytracer_tpu_torch.ops import gather_rows as gr
from clraytracer_tpu_torch.ops import render_fused as rf
from clraytracer_tpu_torch.ops import trace as tr

CAMERA = CameraConfig(position=(0.13, 0.21, 10.0))
W, H = 160, 120
# ``sphere`` at 70k triangles: 69 superclusters in three hyper groups
SCENES = [("two", 4096), ("sphere", 4096), ("sphere", 70000)]
#: K2.1/K2.2 and their plain versions pick the same winner by construction:
#: the least (t, instance, slot) over the candidates, a rule that does not
#: depend on the order the warp visits clusters in, and the kernels cull
#: only boxes with tnear > best t. A box's float slab test can still cull a
#: grazing hit that the plain version's brute force keeps; at most this
#: many rays of a frame may differ
FRAME_MISMATCH_MAX = 16


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the kernels have no CPU build)")
    return torch.device("cuda", 0)


def _camera_rays(device) -> torch.Tensor:
    from clraytracer_tpu_torch.camera import ray_directions_tiled

    cam = Camera.create(CAMERA, W, H)
    d = ray_directions_tiled(
        torch.from_numpy(cam.inverse_view), torch.from_numpy(cam.inverse_projection),
        W, H, rf.tile_rows(W * H),
    ).reshape(3, -1)
    o = torch.from_numpy(cam.position)[:, None].expand_as(d)
    return torch.cat([o, d]).contiguous().to(device)


def _frame_args(scene):
    cam = Camera.create(CAMERA, W, H)
    cr = rf.camera_row(trender.frame_inputs_from_camera(cam, -1.96))
    trows = rf.tile_rows(W * H)
    rows_total = -(-H // trows) * -(-W // 128) * trows
    return (
        tr.kernel_tables(scene), rf.frame_tables(scene), cr, W, H, trows,
        rows_total, 2,
    )


def test_wrappers_refuse_cpu_tensors():
    scene = build_scene("two", device="cpu")
    kt = tr.kernel_tables(scene)
    before = (tr.trace_cuda.launches, rf.render_cuda.launches)
    with pytest.raises(ValueError):
        tr.trace_cuda(kt, _camera_rays("cpu"))
    with pytest.raises(ValueError):
        rf.render_cuda(*_frame_args(scene))
    assert (tr.trace_cuda.launches, rf.render_cuda.launches) == before


def _assert_trace_exact(got, ref, live=None, min_hits=100):
    """K2.1 against trace_plain: the same hit, t, slot and instance on
    every ray (the tie rule makes the winner independent of visit order),
    the attributes within rtol 1e-5 / atol 1e-6; dead lanes -BIG."""
    hit_g, hit_r = got[0].abs() < tr.BIG, ref[0].abs() < tr.BIG
    assert torch.equal(hit_g, hit_r), int((hit_g != hit_r).sum())
    assert hit_r.sum().item() > min_hits
    assert torch.equal(got[0], ref[0])
    assert torch.equal(got[3].view(torch.int32), ref[3].view(torch.int32))
    assert torch.equal(got[4].view(torch.int32), ref[4].view(torch.int32))
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-6)
    if live is not None:
        assert (got[0][live == 0] == -tr.BIG).all()


@pytest.mark.cuda
@pytest.mark.parametrize("spec,tris", SCENES)
def test_trace_kernel_matches_plain_on_card(spec, tris):
    """K2.1 against trace_plain on the same card, with and without a live
    mask: exact in hit, t, slot and instance (``_assert_trace_exact``)."""
    dev = _card()
    kt = tr.kernel_tables(build_scene(spec, tris, device=dev))
    rays = _camera_rays(dev)
    live = (torch.arange(rays.shape[1], device=dev) % 3 != 0).float()
    for lv in (None, live):
        got = tr.trace_cuda(kt, rays, lv)
        ref = tr.trace_plain(kt, rays, lv)
        torch.cuda.synchronize()
        _assert_trace_exact(got, ref, lv)


@pytest.mark.cuda
def test_trace_kernel_tie_rule_on_card():
    """Equal-t hits (tests/_torch_ties.py: one cube instanced twice under
    one transform, a duplicated floor triangle): K2.1 picks the least
    (instance, slot), as trace_plain and the brute-force rule do."""
    from _torch_ties import lex_nearest, package, tie_recipe, tie_rays

    dev = _card()
    kt = tr.kernel_tables(tie_recipe(package("clraytracer_tpu_torch")).build(device=dev))
    rays = torch.from_numpy(tie_rays(4096)).to(dev)
    got = tr.trace_cuda(kt, rays)
    ref = tr.trace_plain(kt, rays)
    torch.cuda.synchronize()
    _assert_trace_exact(got, ref, min_hits=1000)
    t_ref, inst_ref, slot_ref, at_best = lex_nearest(kt, rays)
    hit = torch.isfinite(t_ref)
    assert torch.equal(got[4].view(torch.int32)[hit].long(), inst_ref[hit])
    assert torch.equal(got[3].view(torch.int32)[hit].long(), slot_ref[hit])
    assert int((at_best > 1).sum()) > 1000


@pytest.mark.cuda
def test_trace_kernel_ragged_and_dead_warps_on_card():
    """4097 rays (the last warp holds one ray) and a live mask that kills
    whole warps and every other lane of others: every lane stays in the
    warp's collectives; no hang, no launch error, exact against
    trace_plain."""
    dev = _card()
    kt = tr.kernel_tables(build_scene("two", device=dev))
    rays = _camera_rays(dev)
    rays = torch.cat([rays[:, ::8], rays[:, :1]], dim=1).contiguous()  # 4097
    i = torch.arange(4097, device=dev)
    warp = i // 32
    live = (((warp % 4 != 1) & (i % 2 == 0)) | (warp % 4 == 3)).float()
    assert not live[32:64].any() and live[96:128].all()
    for lv in (None, live):
        got = tr.trace_cuda(kt, rays, lv)
        ref = tr.trace_plain(kt, rays, lv)
        torch.cuda.synchronize()
        _assert_trace_exact(got, ref, lv, min_hits=20)


@pytest.mark.cuda
def test_kernels_more_than_64_hyper_groups_on_card():
    """A 2M-triangle sphere: more hyper groups in one instance than the
    walk holds at once (traverse.cuh CLRT_HQ * 32 = 64), so its hyper
    level runs in two batches. Both kernels against their plain versions."""
    dev = _card()
    scene = build_scene("sphere", 2_000_000, device=dev)
    kt = tr.kernel_tables(scene)
    assert -(-kt.ranges_host[0][1] // 32) > 64
    rays = _camera_rays(dev)
    pick = torch.randperm(rays.shape[1], generator=torch.Generator().manual_seed(0))
    rays = rays[:, pick[:4096].to(dev)].contiguous()
    got = tr.trace_cuda(kt, rays)
    ref = tr.trace_plain(kt, rays)
    torch.cuda.synchronize()
    _assert_trace_exact(got, ref, min_hits=100)
    args = _frame_args(scene)
    bad = (rf.render_cuda(*args) - rf.render_fused_plain(*args, dev)).abs().amax(dim=0) > 1e-5
    assert int(bad.sum()) <= FRAME_MISMATCH_MAX, int(bad.sum())


@pytest.mark.cuda
@pytest.mark.parametrize("spec,tris", SCENES)
def test_render_kernel_matches_plain_on_card(spec, tris):
    """K2.2 against render_fused_plain on the same card: at most
    FRAME_MISMATCH_MAX rays off by more than 1e-5 on the nine planes."""
    dev = _card()
    args = _frame_args(build_scene(spec, tris, device=dev))
    got = rf.render_cuda(*args)
    ref = rf.render_fused_plain(*args, dev)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    bad = (got - ref).abs().amax(dim=0) > 1e-5
    assert int(bad.sum()) <= FRAME_MISMATCH_MAX, int(bad.sum())


@pytest.mark.cuda
def test_kernel_counters_on_card():
    """The optional int64[6] counters (``ops.trace.COUNTER_NAMES``): boxes,
    triangles (32 per cluster a ray reached), ray transforms (one per live
    ray per instance per traversal), hits, the warps' 32-child node tests
    and staged clusters; a launch without them counts nothing, and a
    counters tensor of another shape is refused."""
    dev = _card()
    scene = build_scene("two", device=dev)
    kt = tr.kernel_tables(scene)
    rays = _camera_rays(dev)
    n = rays.shape[1]
    cnt = torch.zeros(6, dtype=torch.int64, device=dev)
    out = tr.trace_cuda(kt, rays, None, cnt)
    boxes, tris, xforms, hits, steps, staged = cnt.tolist()
    assert xforms == n * kt.n_inst
    assert hits == int((out[0].abs() < tr.BIG).sum())
    assert tris % 32 == 0 and boxes >= xforms and tris > 0
    # a staged cluster's test serves at most the warp's 32 rays
    assert 0 < staged and tris <= 32 * 32 * staged
    assert steps >= -(-n // 32) * kt.n_inst
    cnt2 = torch.zeros(6, dtype=torch.int64, device=dev)
    args = _frame_args(scene)
    rf.render_cuda(*args, cnt2)
    rows = args[6] * 128
    assert rows * kt.n_inst <= cnt2[2].item() <= 2 * rows * kt.n_inst
    assert cnt2[3].item() <= 2 * rows
    with pytest.raises(ValueError):
        tr.trace_cuda(kt, rays, None, torch.zeros(4, dtype=torch.int64, device=dev))


@pytest.mark.cuda
def test_render_kernel_bounce1_mostly_missed_warps_on_card():
    """A frame whose bounce-1 warps hold few live lanes: the sphere's
    silhouette cuts the 8 x 4 pixel tiles of render.cu, so most lanes of
    those warps missed at bounce 0 and walk bounce 1 as dead lanes. K2.2
    against render_fused_plain by the frame rule."""
    from clraytracer_tpu_torch.ops.render_fused import tile_rows

    dev = _card()
    scene = build_scene("sphere", device=dev)
    args = _frame_args(scene)
    kt, trows, rows_total = args[0], args[5], args[6]
    # which rays hit at bounce 0, in render.cu's warp tiles (4 strip rows x
    # 8 columns per warp)
    hit0 = (tr.trace_plain(kt, _camera_rays(dev))[0] < tr.BIG).reshape(rows_total, 128)
    assert trows == tile_rows(W * H)
    per_warp = hit0.reshape(rows_total // 4, 4, 16, 8).sum(dim=(1, 3))
    assert int(((per_warp > 0) & (per_warp <= 8)).sum()) >= 4
    got = rf.render_cuda(*args)
    ref = rf.render_fused_plain(*args, dev)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    bad = (got - ref).abs().amax(dim=0) > 1e-5
    assert int(bad.sum()) <= FRAME_MISMATCH_MAX, int(bad.sum())


@pytest.mark.cuda
def test_render_frame_launches_one_kernel_on_card():
    dev = _card()
    scene = build_scene("two", device=dev)
    cam = Camera.create(CAMERA, W, H)
    frame = trender.frame_inputs_from_camera(cam, -1.96)
    cfg = RenderConfig(width=W, height=H)
    before = (rf.render_cuda.launches, tr.trace_cuda.launches)
    img = trender.render_frame(scene, frame, cfg)
    torch.cuda.synchronize()
    assert img.shape == (H, W, 3) and img.device.type == "cuda"
    assert torch.isfinite(img).all()
    assert (rf.render_cuda.launches, tr.trace_cuda.launches) == (
        before[0] + 1, before[1],
    )


def test_gather_wrappers_refuse_cpu_tensors():
    table = torch.zeros(8, 25)
    idx = torch.zeros(16, dtype=torch.int32)
    before = (gr.gather_rows_cuda.launches, gr.scatter_rows_cuda.launches)
    with pytest.raises(ValueError):
        gr.gather_rows_cuda(table, idx)
    with pytest.raises(ValueError):
        gr.scatter_rows_cuda(torch.zeros(25, 16), idx, 8)
    assert (gr.gather_rows_cuda.launches, gr.scatter_rows_cuda.launches) == before


def _gather_case(dev, t_rows, n, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    table = torch.randn(t_rows, 25, generator=g) * 100.0
    idx = torch.randint(-3, t_rows + 3, (n,), generator=g, dtype=torch.int32)
    # coherent runs and a hot row 0, as the tracer's misses give
    idx[: n // 2] = 0
    cot = torch.randn(25, n, generator=g)
    cot[:, : n // 2] = 0.0
    cot[:, n // 2 : n // 2 + 50] = -0.0
    return table.to(dev), idx.to(dev), cot.to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("t_rows", [1, 4224, 20000])
def test_gather_kernel_bit_exact_on_card(t_rows):
    """K2.3 against index_select at clamped indices: bit for bit, any T
    (the TPU kernel stopped at 16384 rows)."""
    dev = _card()
    table, idx, _ = _gather_case(dev, t_rows, 300_001)
    got = gr.gather_rows_cuda(table, idx)
    ref = gr.gather_rows_plain(table, idx)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("t_rows", [1, 4224, 20000])
def test_scatter_kernel_matches_plain_on_card(t_rows):
    """K2.4 against index_add_: per element within 1e-5 * sum |g| + 1e-7
    (atomics add in a varying order); rows nothing lands on are +0."""
    dev = _card()
    _, idx, cot = _gather_case(dev, t_rows, 300_001, seed=1)
    got = gr.scatter_rows_cuda(cot, idx, t_rows)
    ref = gr.scatter_rows_plain(cot, idx, t_rows)
    mag = gr.scatter_rows_plain(cot.abs(), idx, t_rows)
    torch.cuda.synchronize()
    assert ((got - ref).abs() <= 1e-5 * mag + 1e-7).all()
    assert not torch.signbit(got[mag == 0]).any()


def _scatter_case(kind: str, n: int, w: int, t_rows: int = 700, seed: int = 2):
    """K2.4 inputs ([W, n] cotangents, [n] i32 rows) of one kind: every ray
    on one row, runs of equal rows (as neighbouring hit rays give), random
    rows, out-of-range rows that clip, or signed zeros among the
    cotangents."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    cot = torch.randn(w, n, generator=g)
    if kind == "one_row":
        idx = torch.full((n,), 5, dtype=torch.int32)
    elif kind == "runs":
        idx = torch.randint(0, t_rows, (-(-n // 37),), generator=g,
                            dtype=torch.int32).repeat_interleave(37)[:n]
    elif kind == "random":
        idx = torch.randint(0, t_rows, (n,), generator=g, dtype=torch.int32)
    elif kind == "clipped":
        idx = torch.randint(-50, t_rows + 50, (n,), generator=g, dtype=torch.int32)
    else:  # signed zeros: whole rows of -0.0 / +0.0 and zeros mixed with values
        idx = torch.randint(0, 9, (n,), generator=g, dtype=torch.int32)
        cot[:, idx == 3] = -0.0
        cot[:, idx == 4] = 0.0
        mask = torch.rand(w, n, generator=g) < 0.5
        cot = torch.where(mask, torch.where(torch.rand(w, n, generator=g) < 0.5,
                                            -0.0, 0.0), cot)
    return cot, idx


def _assert_scatter_close(cot, idx, t_rows):
    got = gr.scatter_rows_cuda(cot, idx, t_rows)
    ref = gr.scatter_rows_plain(cot, idx, t_rows)
    mag = gr.scatter_rows_plain(cot.abs(), idx, t_rows)
    torch.cuda.synchronize()
    assert got.shape == ref.shape
    assert ((got - ref).abs() <= 1e-5 * mag + 1e-7).all(), float((got - ref).abs().max())
    assert not torch.signbit(got[mag == 0]).any()


@pytest.mark.cuda
@pytest.mark.parametrize("w", [1, 3, 25, 32])
@pytest.mark.parametrize("kind", ["one_row", "runs", "random", "clipped", "signed_zero"])
def test_scatter_kernel_cases_on_card(kind, w):
    """K2.4 (4 rays a thread, warp sums over equal rows) against index_add_
    within 1e-5 * sum |g| + 1e-7 per element, at N a multiple of 4 and not,
    N below a warp, and on an idx that is not 16-byte aligned (one ray a
    thread)."""
    dev = _card()
    t_rows = 700
    for n in (100_004, 1001, 7, 30):
        cot, idx = _scatter_case(kind, n, w, t_rows)
        _assert_scatter_close(cot.to(dev), idx.to(dev), t_rows)
    cot, idx = _scatter_case(kind, 4097, w, t_rows)
    idx = idx.to(dev)[1:]  # 4096 rays at a 4-byte offset
    _assert_scatter_close(cot.to(dev)[:, 1:].contiguous(), idx, t_rows)


@pytest.mark.cuda
def test_diff_step_on_card_matches_cpu():
    """image_loss_and_grads on the card (K2.1, K2.3, K2.4, two launches
    each) against the CPU step (plain versions) on ``two`` at 160x120."""
    from chip_smoke import grads_disagree
    from clraytracer_tpu_torch.diff import image_loss_and_grads, render_image_diff

    dev = _card()
    frame = trender.frame_inputs_from_camera(Camera.create(CAMERA, W, H), -1.96)
    cpu, gpu = build_scene("two", device="cpu"), build_scene("two", device=dev)
    img_c = render_image_diff(cpu, frame, W, H, device="cpu")
    img_g = render_image_diff(gpu, frame, W, H).cpu()
    bad = ((img_g - img_c).abs() > 1e-5).any(dim=-1).double().mean()
    assert bad <= 0.01
    target = torch.zeros(H, W, 3)
    loss_c, g_c = image_loss_and_grads(cpu, frame, W, H, target=target, device="cpu")
    before = (tr.trace_cuda.launches, gr.gather_rows_cuda.launches,
              gr.scatter_rows_cuda.launches)
    loss_g, g_g = image_loss_and_grads(gpu, frame, W, H, target=target.to(dev))
    torch.cuda.synchronize()
    after = (tr.trace_cuda.launches, gr.gather_rows_cuda.launches,
             gr.scatter_rows_cuda.launches)
    assert tuple(a - b for a, b in zip(after, before)) == (2, 2, 2)
    assert abs(float(loss_g) - float(loss_c)) <= 1e-5 * abs(float(loss_c))
    assert set(g_g) == set(g_c)
    assert grads_disagree(g_g, g_c) == []


#: K2.2's option instantiations on the card: (scene of chip_smoke's
#: option_scene, shadows, GI seed or None)
OPTION_CASES = [
    ("atlas", False, None), ("atlas", True, None), ("atlas", False, 3), ("atlas", True, 3),
    ("atlas65", False, None), ("atlas65", True, 3),
    ("sphere", False, 3), ("sphere", True, 3), ("ground", True, None), ("ground", True, 3),
]


@pytest.mark.cuda
@pytest.mark.parametrize("spec,shadows,gi_seed", OPTION_CASES)
def test_render_kernel_options_match_plain_on_card(spec, shadows, gi_seed):
    """Each option of K2.2 (atlas mode 1: ``atlas``, mode 2: ``atlas65``,
    shadows, GI in mode 0 and in the atlas modes) against
    render_fused_plain: pool indices exact, every other plane within 1e-5
    on all but FRAME_MISMATCH_MAX rays, with GI as without."""
    from chip_smoke import compare_options, option_args, option_frame, option_scene

    dev = _card()
    scene = option_scene(spec, device=dev)
    mode = rf.atlas_mode_of(scene)
    assert mode == {"atlas": 1, "atlas65": 2}.get(spec, 0)
    args = option_args(scene, option_frame(spec, W, H), W, H)
    opts = dict(atlas_mode=mode, shadows=shadows, gi_seed=gi_seed)
    before = dict(rf.render_cuda.variant_launches)
    got = rf.render_cuda(*args, **opts)
    ref = rf.render_fused_plain(*args, dev, **opts)
    torch.cuda.synchronize()
    name = rf.variant(mode, shadows, gi_seed is not None)
    assert rf.render_cuda.variant_launches.get(name, 0) == before.get(name, 0) + 1
    assert got.shape == ref.shape == (9 + rf.deferred_planes(mode, gi_seed is not None) * 2,
                                      args[6] * 128)
    case = compare_options(got, ref, mode, gi_seed is not None)
    assert case["ok"], case


@pytest.mark.cuda
def test_shadow_walk_mixed_and_dead_warps_on_card():
    """An odd-sized frame of the ground under the horizon: many warps hold
    both rays that hit at bounce 0 (and walk the shadow ray) and sky rays
    (which walk it as dead lanes), and pad lanes past the image's right
    edge. K2.2 with shadows against render_fused_plain."""
    from chip_smoke import (
        camera_rays, compare_options, option_args, option_frame, option_scene,
    )

    dev = _card()
    w, h = 97, 61
    scene = option_scene("ground", device=dev)
    frame = option_frame("ground", w, h)
    args = option_args(scene, frame, w, h)
    kt, rows_total = args[0], args[6]
    rays, _ = camera_rays(w, h, dev, frame)
    hit0 = (tr.trace_plain(kt, rays)[0] < tr.BIG).reshape(rows_total // 4, 4, 16, 8)
    per_warp = hit0.sum(dim=(1, 3))
    assert int(((per_warp > 0) & (per_warp < 32)).sum()) >= 4
    got = rf.render_cuda(*args, atlas_mode=0, shadows=True)
    ref = rf.render_fused_plain(*args, dev, atlas_mode=0, shadows=True)
    torch.cuda.synchronize()
    case = compare_options(got, ref, 0, False)
    assert case["ok"], case
    unshadowed = rf.render_cuda(*args)
    assert (got[0:3] <= unshadowed[0:3] + 1e-6).all()
    assert (got[0:3] < unshadowed[0:3] - 1e-3).any()


#: every shadow instantiation: (scene of chip_smoke's option_scene, GI)
SHADOW_CASES = [(spec, gi) for spec in ("sphere", "atlas", "atlas65") for gi in (None, 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("spec,gi_seed", SHADOW_CASES)
def test_shadow_any_hit_exact_on_backlit_sphere_on_card(spec, gi_seed):
    """Each shadow instantiation (atlas modes 0/1/2, GI off and on) against
    render_fused_plain, whose shadow ray is a nearest-hit trace_plain, on a
    sphere lit from behind (sun angle 0: the shadow rays head away from
    the camera, through the sphere), so most bounce-0 hits are in shadow
    and their any-hit walks end early: 0 rays differ, max abs error 0."""
    from chip_smoke import (
        BACKLIT_SUN, camera_rays, compare_options, option_args, option_frame,
        option_scene, shadowed_hits,
    )

    dev = _card()
    scene = option_scene(spec, device=dev)
    mode = rf.atlas_mode_of(scene)
    frame = option_frame(spec, W, H, sun=BACKLIT_SUN)
    args = option_args(scene, frame, W, H)
    rays, _ = camera_rays(W, H, dev, frame)
    in_shadow, hits = shadowed_hits(args[0], rays, args[2].sun)
    assert in_shadow > 0.8 * hits > 0, (in_shadow, hits)
    opts = dict(atlas_mode=mode, shadows=True, gi_seed=gi_seed)
    got = rf.render_cuda(*args, **opts)
    ref = rf.render_fused_plain(*args, dev, **opts)
    torch.cuda.synchronize()
    case = compare_options(got, ref, mode, gi_seed is not None)
    assert case["rays_differing"] == 0 and case["max_abs_err_all"] == 0.0, case


@pytest.mark.cuda
@pytest.mark.parametrize("mode,gi_seed", [(m, gi) for m in (0, 1, 2) for gi in (None, 3)])
def test_shadow_instantiations_mixed_and_dead_warps_on_card(mode, gi_seed):
    """test_shadow_walk_mixed_and_dead_warps_on_card's odd-sized ground
    frame (warps of shadow walkers, sky rays and pad lanes) under every
    shadow instantiation: the kernel's atlas mode is forced, and its
    deferred planes are held against the plain version's on the same
    inputs. 0 rays differ, max abs error 0."""
    from chip_smoke import compare_options, option_args, option_frame, option_scene

    dev = _card()
    w, h = 97, 61
    scene = option_scene("ground", device=dev)
    args = option_args(scene, option_frame("ground", w, h), w, h)
    opts = dict(atlas_mode=mode, shadows=True, gi_seed=gi_seed)
    got = rf.render_cuda(*args, **opts)
    ref = rf.render_fused_plain(*args, dev, **opts)
    torch.cuda.synchronize()
    case = compare_options(got, ref, mode, gi_seed is not None)
    assert case["rays_differing"] == 0 and case["max_abs_err_all"] == 0.0, case


@pytest.mark.cuda
def test_shadow_counters_add_up_on_card():
    """The shadow walk's own int64[6] counts: no interpolated hits, at most
    one transform per bounce-0 hit and instance, each count within the
    launch's total; and the total less them is exactly the default
    instantiation's counts on the same frame (the primary walks are the
    same walks). A launch without shadows refuses shadow counters, and a
    counter tensor of another shape is refused."""
    from chip_smoke import option_args, option_frame, option_scene

    dev = _card()
    scene = option_scene("ground", device=dev)
    args = option_args(scene, option_frame("ground", W, H), W, H)
    kt = args[0]
    total = torch.zeros(6, dtype=torch.int64, device=dev)
    shadow = torch.zeros(6, dtype=torch.int64, device=dev)
    rf.render_cuda(*args, total, shadows=True, shadow_counters=shadow)
    plain = torch.zeros(6, dtype=torch.int64, device=dev)
    rf.render_cuda(*args, plain)
    torch.cuda.synchronize()
    s, t = shadow.tolist(), total.tolist()
    # shaded hits (t[3]) include every bounce-0 hit, each of which walks
    # one shadow ray
    assert s[3] == 0 and 0 < s[2] <= t[3] * kt.n_inst
    assert s[0] > 0 and s[1] > 0 and s[4] > 0
    assert all(0 <= a <= b for a, b in zip(s, t))
    assert (total - shadow).tolist() == plain.tolist()
    before = rf.render_cuda.launches
    with pytest.raises(ValueError):
        rf.render_cuda(*args, shadow_counters=shadow)
    with pytest.raises(ValueError):
        rf.render_cuda(*args, shadows=True,
                       shadow_counters=torch.zeros(4, dtype=torch.int64, device=dev))
    assert rf.render_cuda.launches == before


@pytest.mark.cuda
def test_render_frame_options_on_card_match_cpu():
    """render_frame with imported textures, shadows, GI and 4 samples on the
    card: one launch of the atlas1+shadows+gi instantiation per sample,
    the image against the CPU frame (plain versions) on at least 98% of
    pixels within 1e-3 (GI's tolerance)."""
    from chip_smoke import option_frame, option_scene

    dev = _card()
    cfg = RenderConfig(width=W, height=H, enable_shadows=True, enable_gi=True, samples=4)
    frame = option_frame("atlas", W, H)
    img_c = trender.render_frame(option_scene("atlas", device="cpu"), frame, cfg, device="cpu")
    before = dict(rf.render_cuda.variant_launches)
    img_g = trender.render_frame(option_scene("atlas", device=dev), frame, cfg)
    torch.cuda.synchronize()
    name = "atlas1+shadows+gi"
    assert rf.render_cuda.variant_launches[name] == before.get(name, 0) + 4
    assert torch.isfinite(img_g).all()
    close = ((img_g.cpu() - img_c).abs() <= 1e-3).all(dim=-1).double().mean()
    assert close >= 0.98, float(close)


@pytest.mark.cuda
def test_render_kernel_refuses_unknown_atlas_mode_on_card():
    dev = _card()
    args = _frame_args(build_scene("two", device=dev))
    before = rf.render_cuda.launches
    with pytest.raises(ValueError):
        rf.render_cuda(*args, atlas_mode=3)
    assert rf.render_cuda.launches == before
