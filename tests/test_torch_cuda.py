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


def _quad_scene(device):
    """One 8 x 8 ground quad (2 triangles, one cluster) at y = 0."""
    from clraytracer_tpu_torch.scene import SceneBuilder
    from clraytracer_tpu_torch.scene import procedural_tex as ptex
    from clraytracer_tpu_torch.scene.procedural import quad

    b = SceneBuilder()
    b.import_procedural(ptex.sky_gradient(32, 16))
    b.add_instance(b.add_mesh(quad(8.0, y=0.0),
                              materials_start=b.create_material(albedo=(0.8, 0.8, 0.8))))
    return b.build(device=device)


@pytest.mark.cuda
def test_kernel_counters_on_card():
    """The optional int64[6] counters (``ops.trace.COUNTER_NAMES``): boxes,
    triangles (the real, non-padding slots of each cluster a ray reached:
    on a lone quad, whose one cluster holds 2 triangles, 2 a ray, in K2.1
    and in K2.2's bounce 0, its reflected rays passing no box), ray
    transforms (one per live ray per instance per traversal), hits, the
    warps' 32-child node tests and staged clusters; a launch without them
    counts nothing, and a counters tensor of another shape is refused."""
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
    assert boxes >= xforms and tris > 0
    # a staged cluster's test serves at most the warp's 32 rays, each
    # against at most its real slots
    real = (kt.planes[:, :3] != 0).any(dim=1).reshape(-1, 32).sum(dim=1)
    assert int(real.min()) < 32  # partial clusters: the cube's, the sphere's last
    assert 0 < staged and tris <= 32 * int(real.max()) * staged
    quad = _quad_scene(dev)
    qkt = tr.kernel_tables(quad)
    g = torch.Generator().manual_seed(5)
    m = 4096
    qrays = torch.cat([torch.rand(3, m, generator=g) * 6.0 - 3.0, torch.zeros(3, m)])
    qrays[1], qrays[4] = 5.0, -1.0  # from y = 5 straight down onto the quad
    qrays = qrays.contiguous().to(dev)
    qc = torch.zeros(6, dtype=torch.int64, device=dev)
    tr.trace_cuda(qkt, qrays, None, qc)
    assert qc[1].item() == 2 * m and qc[3].item() == m
    qc.zero_()
    qargs = (qkt, rf.frame_tables(quad), rf.ray_row(torch.tensor(-1.96)), 128, m // 128,
             m // 128, m // 128, 2)
    rf.render_cuda(*qargs, qc, rays=qrays)
    assert qc[1].item() == 2 * m and qc[3].item() == m
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


#: K2.2's ray-mode instantiations: (scene of chip_smoke's option_scene,
#: shadows, GI seed or None), atlas modes 0, 1 and 2 each with every option
RAY_CASES = [(spec, sh, gi) for spec in ("sphere", "atlas", "atlas65")
             for sh in (False, True) for gi in (None, 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("spec,shadows,gi_seed", RAY_CASES)
def test_ray_mode_matches_plain_and_camera_mode_on_card(spec, shadows, gi_seed):
    """Each ray-mode instantiation of K2.2: on rays whose origins and
    directions differ lane by lane (chip_smoke's jittered camera rays)
    against render_fused_plain on the same rays (pool indices exact, other
    planes within 1e-5 on all but FRAME_MISMATCH_MAX rays); on the
    camera's own tiled rays bit for bit equal to the camera-mode launch."""
    from chip_smoke import (
        camera_rays, compare_options, jittered_rays, option_args, option_frame, option_scene,
    )

    dev = _card()
    scene = option_scene(spec, device=dev)
    mode = rf.atlas_mode_of(scene)
    frame = option_frame(spec, W, H)
    args = option_args(scene, frame, W, H)
    opts = dict(atlas_mode=mode, shadows=shadows, gi_seed=gi_seed)
    rays, _ = camera_rays(W, H, dev, frame)
    before = dict(rf.render_cuda.variant_launches)
    cam = rf.render_cuda(*args, **opts)
    same = rf.render_cuda(*args, rays=rays, **opts)
    jr = jittered_rays(rays, 11)
    got = rf.render_cuda(*args, rays=jr, **opts)
    ref = rf.render_fused_plain(*args, dev, rays=jr, **opts)
    torch.cuda.synchronize()
    name = rf.variant(mode, shadows, gi_seed is not None, True)
    assert rf.render_cuda.variant_launches[name] == before.get(name, 0) + 2
    assert torch.equal(same.view(torch.int32), cam.view(torch.int32))
    case = compare_options(got, ref, mode, gi_seed is not None)
    assert case["ok"], case


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 127, 4000, 12345])
def test_ray_mode_ragged_last_warp_on_card(n):
    """n rays, not a multiple of 32 * 4: the launch's last warps hold lanes
    past n, which walk as dead rays and write nothing; the n columns equal
    the plain version's and the first n of a launch on the rays padded to
    whole rows."""
    from chip_smoke import (
        camera_rays, compare_options, option_args, option_frame, option_scene,
    )

    dev = _card()
    scene = option_scene("ground", device=dev)
    frame = option_frame("ground", W, H)
    rays, _ = camera_rays(W, H, dev, frame)
    rays = rays[:, :n].contiguous()
    rows = -(-n // 128)
    kt, ft, cr = option_args(scene, frame, W, H)[:3]
    args = (kt, ft, cr, W, H, rows, rows, 2)
    opts = dict(shadows=True, gi_seed=3)
    got = rf.render_cuda(*args, rays=rays, **opts)
    ref = rf.render_fused_plain(*args, dev, rays=rays, **opts)
    padded = torch.cat([rays, torch.zeros(6, rows * 128 - n, device=dev)], 1).contiguous()
    full = rf.render_cuda(*args, rays=padded, **opts)
    torch.cuda.synchronize()
    assert got.shape == (9, n)
    assert compare_options(got, ref, 0, True)["ok"]
    assert torch.equal(got, full[:, :n])


@pytest.mark.cuda
def test_trace_planar_launches_one_ray_mode_kernel_on_card():
    """render.trace_planar with K2.1's tracer and integer colours: one
    launch of K2.2 in ray mode and no K2.1; with float colours the
    two-phase path: two K2.1 launches and no K2.2. Both finite, and the
    ray-mode image against the CPU's (plain versions) on at least 99% of
    pixels within 1e-5 (the sky's atan2/acos may round apart between the
    two devices)."""
    from clraytracer_tpu_torch.camera import ray_directions_planar

    dev = _card()
    gpu, cpu = build_scene("sphere", device=dev), build_scene("sphere", device="cpu")
    cam = Camera.create(CAMERA, W, H)
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
    d = ray_directions_planar(f32(cam.inverse_view), f32(cam.inverse_projection), W, H)
    o = f32(cam.position)[:, None, None].expand_as(d)
    sun = torch.tensor(-1.96, device=dev)
    before = (rf.render_cuda.launches, tr.trace_cuda.launches,
              rf.render_cuda.variant_launches.get("rays", 0))
    img = trender.trace_planar(gpu, o, d, sun, 2, tr.trace, True, True)
    torch.cuda.synchronize()
    after = (rf.render_cuda.launches, tr.trace_cuda.launches,
             rf.render_cuda.variant_launches.get("rays", 0))
    assert tuple(a - b for a, b in zip(after, before)) == (1, 0, 1)
    ref = trender.trace_planar(cpu, o.cpu(), d.cpu(), sun.cpu(), 2, tr.trace, True, True)
    assert torch.isfinite(img).all()
    assert ((img.cpu() - ref).abs() <= 1e-5).all(dim=0).double().mean() >= 0.99
    before = (rf.render_cuda.launches, tr.trace_cuda.launches)
    img = trender.trace_planar(gpu, o, d, sun, 2, tr.trace, True, False)
    torch.cuda.synchronize()
    assert (rf.render_cuda.launches - before[0], tr.trace_cuda.launches - before[1]) == (0, 2)
    assert torch.isfinite(img).all()


@pytest.mark.cuda
def test_render_frame_two_phase_on_card_matches_cpu():
    """render_frame on the two-phase path on the card (refraction; float
    colours with shadows; material shading): K2.1 per bounce and shadow
    ray, no K2.2, the image against the CPU's on at least 99% of pixels
    within 1e-5."""
    from chip_smoke import option_frame, option_scene

    dev = _card()
    for spec, kw, k21 in (("glass", dict(enable_refraction=True), 2),
                          ("ground", dict(integer_colors=False, enable_shadows=True), 3),
                          ("sphere", dict(reference_parity_shading=False), 2)):
        cfg = RenderConfig(width=W, height=H, **kw)
        frame = option_frame(spec, W, H)
        img_c = trender.render_frame(option_scene(spec, device="cpu"), frame, cfg,
                                     device="cpu")
        scene = option_scene(spec, device=dev)
        before = (rf.render_cuda.launches, tr.trace_cuda.launches)
        img_g = trender.render_frame(scene, frame, cfg)
        torch.cuda.synchronize()
        assert (rf.render_cuda.launches - before[0], tr.trace_cuda.launches - before[1]) == (
            0, k21), spec
        close = ((img_g.cpu() - img_c).abs() <= 1e-5).all(dim=-1).double().mean()
        assert close >= 0.99, (spec, float(close))


CARRY_CASES = [("sphere", False, 2), ("ground", False, 1), ("ground", True, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("spec,shadows,rest", CARRY_CASES)
def test_carry_instantiations_match_plain_on_card(spec, shadows, rest):
    """The split-rebin carry's three instantiations against their plain
    versions at 320x240, to the frame rule: the carry-out launch (camera
    mode, bounce 0, 19 planes) without and with shadows, and the carry-in
    launch (ray mode from global bounce 1, over ``rest`` bounces) on the
    rows that ``rebin_rows`` re-bins from the plain carry-out's output."""
    from chip_smoke import compare_options, option_args, option_frame, option_scene

    dev = _card()
    w, h = 320, 240
    scene = option_scene(spec, device=dev)
    args = option_args(scene, option_frame(spec, w, h), w, h, bounces=1)
    before = dict(rf.render_cuda.variant_launches)
    got = rf.render_cuda(*args, carry_out=True, shadows=shadows)
    ref = rf.render_fused_plain(*args, dev, carry_out=True, shadows=shadows)
    torch.cuda.synchronize()
    assert got.shape == (19, args[6] * 128)
    case = compare_options(got, ref, 0, False)
    assert case["ok"], case
    rays, carry, _inv = rf.rebin_rows(ref, args[6])
    assert 0 < int((carry[12] > 0.5).sum()) < carry.shape[1]
    kw = dict(rays=rays, carry=carry, start_bounce=1, shadows=shadows)
    got = rf.render_cuda(*args[:7], rest, **kw)
    ref = rf.render_fused_plain(*args[:7], rest, dev, **kw)
    torch.cuda.synchronize()
    case = compare_options(got, ref, 0, False)
    assert case["ok"], case
    out_name = rf.variant(0, shadows, False, carry="out")
    in_name = rf.variant(0, False, False, True, "in")
    after = rf.render_cuda.variant_launches
    assert after[out_name] == before.get(out_name, 0) + 1
    assert after[in_name] == before.get(in_name, 0) + 1
    with pytest.raises(ValueError):  # the carry-in launch walks no shadow ray
        rf.render_cuda(*args[:7], rest, shadow_counters=torch.zeros(
            6, dtype=torch.int64, device=dev), **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("spec,shadows", [("sphere", False), ("two", False),
                                          ("ground", False), ("ground", True)])
def test_split_frame_matches_unsplit_on_card(spec, shadows):
    """render_fused_camera(split_rebin=True) on the card: exactly two K2.2
    launches (carry-out in camera mode, then carry-in in ray mode) and no
    K2.1 nor any plain version; its image within the frame rule of the
    unsplit frame's (a re-binned warp holds other rays, and a
    triangles-outer leaf tests lanes whose own boxes culled it)."""
    from chip_smoke import option_frame, option_scene

    dev = _card()
    w, h = 320, 240
    scene = option_scene(spec, device=dev)
    frame = option_frame(spec, w, h)
    one, lay1 = rf.render_fused_camera(scene, frame, w, h, 2, enable_shadows=shadows)
    plain = rf.render_fused_plain
    rf.render_fused_plain = None  # the card never reaches the plain version
    try:
        before = (rf.render_cuda.launches, tr.trace_cuda.launches,
                  dict(rf.render_cuda.variant_launches))
        split, lay2 = rf.render_fused_camera(scene, frame, w, h, 2, enable_shadows=shadows,
                                             split_rebin=True)
        torch.cuda.synchronize()
    finally:
        rf.render_fused_plain = plain
    after = rf.render_cuda.variant_launches
    assert (rf.render_cuda.launches - before[0], tr.trace_cuda.launches - before[1]) == (2, 0)
    for name in (rf.variant(0, shadows, False, carry="out"), rf.variant(0, False, False, True, "in")):
        assert after[name] == before[2].get(name, 0) + 1
    assert lay1 == lay2 and torch.isfinite(split).all()
    bad = ((split - one).abs() > 1e-5).any(dim=0)
    print(f"{spec}: {int(bad.sum())} rays differ from the unsplit frame")
    assert int(bad.sum()) <= FRAME_MISMATCH_MAX


@pytest.mark.cuda
@pytest.mark.parametrize("split", [False, True])
def test_row_windows_stack_to_the_full_frame_on_card(split):
    """row0/local_height on the card: rows 0-79, 80-159 and 160-239 of a
    320x240 frame, each rendered alone and untiled, stack to the full
    frame: bit for bit unsplit (a window's warps hold the full frame's 8x4
    pixel tiles), within the frame rule split (the re-bin groups rows
    otherwise)."""
    from chip_smoke import option_frame, option_scene

    dev = _card()
    w, h, win = 320, 240, 80
    scene = option_scene("ground", device=dev)
    frame = option_frame("ground", w, h)
    full, lay = rf.render_fused_camera(scene, frame, w, h, 2, enable_shadows=True,
                                       split_rebin=split)
    want = trender._untile(full, ("strip",) + lay, h, w)
    parts = []
    for y0 in range(0, h, win):
        img, wlay = rf.render_fused_camera(scene, frame, w, h, 2, enable_shadows=True,
                                           row0=y0, local_height=win, split_rebin=split)
        parts.append(trender._untile(img, ("strip",) + wlay, win, w))
    got = torch.cat(parts, dim=1)
    torch.cuda.synchronize()
    if not split:
        assert torch.equal(got, want)
    bad = ((got - want).abs() > 1e-5).any(dim=0)
    assert int(bad.sum()) <= FRAME_MISMATCH_MAX


def _small_obj(tmp_path):
    """A two-material OBJ (a sphere in two latitude halves and a quad-grid
    floor) with PNG diffuse maps written with every row filter
    (chip_smoke's writers)."""
    import numpy as np

    from chip_smoke import _quad_grid, _soup, museum_texture, obj_text, png_bytes
    from clraytracer_tpu_torch.scene.procedural import uv_sphere

    s = _soup(uv_sphere(1.5, 12, 24))
    top = s[0][:, :, 1].mean(axis=1) > 0
    groups = [("top", tuple(c[top] for c in s)), ("bottom", tuple(c[~top] for c in s)),
              ("floor", _quad_grid(6, (-4, -1.5, -4), (8, 0, 0), (0, 0, 8), (0, 1, 0), 3.0))]
    mtl = []
    for k, (name, _) in enumerate(groups):
        (tmp_path / f"{name}.png").write_bytes(png_bytes(museum_texture(k, 32)))
        mtl += [f"newmtl {name}", "Kd 0.8 0.7 0.6", f"map_Kd {name}.png"]
    (tmp_path / "m.mtl").write_text("\n".join(mtl) + "\n")
    (tmp_path / "m.obj").write_text(obj_text(groups, "m.mtl"))
    return tmp_path / "m.obj"


@pytest.mark.cuda
def test_imported_obj_frame_on_card_matches_cpu(tmp_path):
    """An imported OBJ scene's default frame on the card: one launch of
    K2.2's atlas-mode-1 instantiation, the image against the CPU frame
    (plain versions) on at least 99% of pixels within 1e-5."""
    dev = _card()
    path = _small_obj(tmp_path)
    cfg = RenderConfig(width=W, height=H)
    frame = trender.frame_inputs_from_camera(Camera.create(CAMERA, W, H), -1.96)
    img_c = trender.render_frame(build_scene(str(path), device="cpu"), frame, cfg,
                                 device="cpu")
    scene = build_scene(str(path), device=dev)
    assert rf.atlas_mode_of(scene) == 1
    before = (rf.render_cuda.launches, dict(rf.render_cuda.variant_launches),
              tr.trace_cuda.launches)
    img_g = trender.render_frame(scene, frame, cfg)
    torch.cuda.synchronize()
    assert rf.render_cuda.launches == before[0] + 1
    assert rf.render_cuda.variant_launches["atlas1"] == before[1].get("atlas1", 0) + 1
    assert tr.trace_cuda.launches == before[2]
    assert torch.isfinite(img_g).all()
    close = ((img_g.cpu() - img_c).abs() <= 1e-5).all(dim=-1).double().mean()
    assert close >= 0.99, float(close)


@pytest.mark.cuda
def test_reference_tracers_on_card_match_cpu(tmp_path):
    """trace_wavefront and trace_bvh (plain torch) on CUDA tensors against
    the same calls on the CPU, with and without a live mask: hit, triangle
    and instance equal on all but FRAME_MISMATCH_MAX rays (a float sum
    reduced in another order on the card can flip a grazing hit), t/u/v
    within 1e-5 where they agree; no kernel launched."""
    from clraytracer_tpu_torch.ops.trace_ref import trace_bvh
    from clraytracer_tpu_torch.ops.trace_wavefront import trace_wavefront

    dev = _card()
    path = _small_obj(tmp_path)
    cpu, gpu = build_scene(str(path), device="cpu"), build_scene(str(path), device=dev)
    rays = _camera_rays("cpu")
    o, d = rays[:3], rays[3:]
    live = torch.arange(o.shape[1]) % 3 != 0
    before = (rf.render_cuda.launches, tr.trace_cuda.launches)
    for fn in (trace_wavefront, trace_bvh):
        for lv in (None, live):
            ref = fn(cpu, o, d, live=lv)
            got = fn(gpu, o.to(dev), d.to(dev), live=None if lv is None else lv.to(dev))
            same = ((got.hit.cpu() == ref.hit) & (got.tri.cpu() == ref.tri)
                    & (got.instance.cpu() == ref.instance))
            assert int((~same).sum()) <= FRAME_MISMATCH_MAX, fn.__name__
            assert int(ref.hit.sum()) > 1000
            both = same & ref.hit
            for f in ("t", "u", "v"):
                diff = (getattr(got, f).cpu() - getattr(ref, f))[both].abs().max()
                assert float(diff) <= 1e-5, (fn.__name__, f)
    assert (rf.render_cuda.launches, tr.trace_cuda.launches) == before


def test_png_decoder_without_pil(tmp_path, monkeypatch):
    """The port's own decoder (PIL hidden, as on a machine without it) reads
    back what chip_smoke.png_bytes wrote, every row filter in turn, in
    texture-size images, and refuses a JPEG by name."""
    import sys

    import numpy as np

    from chip_smoke import museum_texture, png_bytes
    from clraytracer_tpu_torch.scene import imagefile, textures

    monkeypatch.setitem(sys.modules, "PIL", None)
    assert textures.image_decoder() == "port"
    for k, filters in enumerate(((0, 1, 2, 3, 4), (4,), (3, 1), (2, 0))):
        img = museum_texture(k, 256)
        (tmp_path / f"{k}.png").write_bytes(png_bytes(img, filters))
        np.testing.assert_array_equal(textures.decode_rgb8(tmp_path / f"{k}.png"), img)
    (tmp_path / "x.jpg").write_bytes(b"\xff\xd8\xff\xe0" + bytes(64))
    with pytest.raises(imagefile.UnsupportedImageError, match="JPEG"):
        textures.decode_rgb8(tmp_path / "x.jpg")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 3, 33])
def test_trace_kernel_few_rays_on_card(n):
    """A pick's launch: K2.1 on 1, 3 and 33 rays (one warp partly empty,
    two warps), exact against trace_plain; the lanes past n stay in the
    warp's walk."""
    dev = _card()
    kt = tr.kernel_tables(build_scene("sphere", device=dev))
    rays = _camera_rays(dev)
    hit = (tr.trace_plain(kt, rays)[0].abs() < tr.BIG).nonzero()[:, 0]
    pick = torch.cat([hit[: (n + 1) // 2], torch.arange(n // 2, device=dev)])
    sub = rays[:, pick].contiguous()
    before = tr.trace_cuda.launches
    got = tr.trace_cuda(kt, sub)
    ref = tr.trace_plain(kt, sub)
    torch.cuda.synchronize()
    assert tr.trace_cuda.launches == before + 1
    _assert_trace_exact(got, ref, min_hits=0)
    assert int((got[0].abs() < tr.BIG).sum()) == (n + 1) // 2


@pytest.mark.cuda
def test_pick_through_k21_on_card_matches_cpu():
    """``pick`` with ``tracer=trace_best`` on the card: one K2.1 launch, the
    CPU's record (K2.1's plain version) within 1e-5."""
    import numpy as np

    from clraytracer_tpu_torch.raycast import pick

    dev = _card()
    cam = Camera.create(CAMERA, W, H)
    gpu, cpu = build_scene("two", device=dev), build_scene("two", device="cpu")
    for x, y in ((55.0, 50.0), (110.0, 62.0), (2.0, 2.0)):
        before = tr.trace_cuda.launches
        got = pick(gpu, cam, x, y, trender.trace_best)
        assert tr.trace_cuda.launches == before + 1
        ref = pick(cpu, cam, x, y, trender.trace_best)
        for f in ("hit", "index", "instance"):
            assert getattr(got, f) == getattr(ref, f), f
        for f in ("distance", "normal", "uv", "color"):
            np.testing.assert_allclose(getattr(got, f), getattr(ref, f), rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_engine_frame_equals_render_frame_on_card():
    """``Engine.render`` with the default tracer is ``render_frame``: one
    K2.2 launch a frame, the image bit-equal to ``render_frame`` on a scene
    built from the same builder state, before and after an instance move;
    the geometry tables survive the tick."""
    from clraytracer_tpu_torch import math3d
    from clraytracer_tpu_torch.engine import Engine
    from clraytracer_tpu_torch.scene import SceneBuilder
    from clraytracer_tpu_torch.scene import procedural_tex as ptex
    from clraytracer_tpu_torch.scene.procedural import cube, uv_sphere

    dev = _card()
    b = SceneBuilder()
    b.import_procedural(ptex.sky_gradient(256, 128))
    checker = b.import_procedural(ptex.checker(64, 8))
    m1 = b.create_material(albedo=(0.9, 0.2, 0.2), albedo_tex=checker)
    m2 = b.create_material(albedo=(0.2, 0.9, 0.2))
    b.add_instance(b.add_mesh(uv_sphere(1.5, 24, 48), materials_start=m1),
                   math3d.translation(-2.0, 1.0, 0.0))
    b.add_instance(b.add_mesh(cube(1.0), materials_start=m2), math3d.translation(2.5, 0.5, -1.0))
    cfg = RenderConfig(width=W, height=H, frame_watchdog_ms=80.0)
    eng = Engine(b, cfg, CAMERA)
    eng.start()
    for step in range(3):
        if step:
            eng.set_instance_transform(1, math3d.rotation_y(0.3 * step)
                                       @ math3d.translation(2.5, 0.5, -1.0))
            eng.tick()
        kt = tr.kernel_tables(eng.scene)
        before = rf.render_cuda.launches
        img = eng.render()
        eng.end_frame()
        assert rf.render_cuda.launches == before + 1 and img.device.type == "cuda"
        fresh = b.build(device=dev)
        frame = trender.frame_inputs_from_camera(eng.camera, eng.sun_angle)
        ref = trender.render_frame(fresh, frame, RenderConfig(width=W, height=H))
        assert torch.equal(img, ref), step
        if step:
            for f in ("planes", "attrs", "cluster_box", "tri_gid"):
                assert getattr(kt, f).data_ptr() == getattr(kt0, f).data_ptr(), f
        kt0 = kt


# ---------------------------------------------------------------------------
# the multi-device layer (parallel/) on the card: NCCL takes one rank per
# card, so one card holds a 1-rank NCCL group in this process and gloo
# ranks as processes (tests/_torch_dist_worker.py)
# ---------------------------------------------------------------------------

SHARD_WH = (320, 239)  # 2 windows of 120 rows: the last runs past H


def _nccl_one_rank(tmp_path):
    """A 1-rank NCCL group in this process; the caller destroys it."""
    import datetime

    import torch.distributed as dist

    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/nccl", world_size=1,
                            rank=0, timeout=datetime.timedelta(seconds=120),
                            device_id=torch.device("cuda", 0))


def _counts():
    return {"K2.1": tr.trace_cuda.launches, "K2.2": rf.render_cuda.launches,
            "K2.3": gr.gather_rows_cuda.launches, "K2.4": gr.scatter_rows_cuda.launches}


def _shard_frame(w, h):
    return trender.frame_inputs_from_camera(Camera.create(CAMERA, w, h), -1.96)


@pytest.mark.cuda
def test_render_sharded_nccl_one_rank_equals_gloo_two_ranks_on_card(tmp_path):
    """``render_sharded`` on (a)'s sphere at 320x239: one K2.2 launch on a
    1-rank NCCL group, bit-equal to each rank's frame of 2 gloo ranks on the
    same card (the last window past H), and within the frame rule of
    ``render_frame``."""
    import torch.distributed as dist

    import _torch_dist_worker as worker
    from clraytracer_tpu_torch.parallel import sharding as sh

    dev = _card()
    w, h = SHARD_WH
    scene = build_scene("sphere", 4096, device=dev)
    frame = _shard_frame(w, h)
    cfg = RenderConfig(width=w, height=h)
    _nccl_one_rank(tmp_path)
    try:
        mesh = sh.make_device_mesh()
        before = _counts()
        one = sh.render_sharded(scene, frame, cfg, mesh).cpu()
        after = _counts()
    finally:
        dist.destroy_process_group()
    assert {k: after[k] - before[k] for k in after} == {"K2.1": 0, "K2.2": 1, "K2.3": 0,
                                                         "K2.4": 0}
    ranks = worker.wait(worker.start(2, tmp_path, {
        "device": "cuda", "scenes": {"sphere": {"cli": ("sphere", 4096)}},
        "cases": [dict(kind="render", name="img", scene="sphere", tracer="best",
                       wh=SHARD_WH)],
    }), tmp_path, 300)
    for r in ranks:
        assert torch.equal(torch.from_numpy(r["img"]), one)
    ref = trender.render_frame(scene, frame, cfg).cpu()
    assert int(((one - ref).abs() > 1e-5).any(dim=-1).sum()) <= FRAME_MISMATCH_MAX


@pytest.mark.cuda
def test_k22_row_window_past_height_on_card():
    """K2.2 in camera mode on the last window of a 2-way 320x239 split (rows
    120-239, one past H): within the plane rule of its plain version, and
    its rows below H bit-equal to the whole frame's."""
    from chip_smoke import compare_options

    dev = _card()
    w, h = SHARD_WH
    rows = -(-h // 2)
    scene = build_scene("sphere", 4096, device=dev)
    frame = _shard_frame(w, h)
    trows = rf.tile_rows(w * rows)
    rows_total = -(-rows // trows) * -(-w // 128) * trows
    args = (tr.kernel_tables(scene), rf.frame_tables(scene), rf.camera_row(frame, rows),
            w, h, trows, rows_total, 2)
    got = rf.render_cuda(*args)
    ref = rf.render_fused_plain(*args, dev)
    torch.cuda.synchronize()
    assert compare_options(got, ref, 0, False)["ok"]
    win, wlay = rf.render_fused_camera(scene, frame, w, h, 2, row0=rows, local_height=rows)
    full, lay = rf.render_fused_camera(scene, frame, w, h, 2)
    win = trender._untile(win, ("strip",) + wlay, rows, w)
    full = trender._untile(full, ("strip",) + lay, h, w)
    assert torch.equal(win[:, : h - rows], full[:, rows:])


@pytest.mark.cuda
def test_train_step_sharded_one_rank_on_card(tmp_path):
    """``train_step_sharded`` on a 1-rank NCCL group at 160x120 against
    ``image_loss_and_grads``: the loss, and the albedo gradient the update
    implies at the JAX tests' rtol 2e-2 / atol 1e-5; K2.1, K2.3 and K2.4
    twice each a step (2 bounces)."""
    import numpy as np
    import torch.distributed as dist

    from clraytracer_tpu_torch.diff import image_loss_and_grads
    from clraytracer_tpu_torch.parallel import sharding as sh

    dev = _card()
    scene = build_scene("sphere", 4096, device=dev)
    frame = _shard_frame(W, H)
    target = torch.from_numpy(
        np.random.default_rng(0).uniform(0.0, 1.0, (H, W, 3)).astype(np.float32)).to(dev)
    _nccl_one_rank(tmp_path)
    try:
        mesh = sh.make_device_mesh()
        before = _counts()
        loss, new = sh.train_step_sharded(scene, frame, target, mesh, lr=1.0)
        torch.cuda.synchronize()
        after = _counts()
    finally:
        dist.destroy_process_group()
    assert {k: after[k] - before[k] for k in after} == {"K2.1": 2, "K2.2": 0, "K2.3": 2,
                                                         "K2.4": 2}
    loss_ref, g = image_loss_and_grads(scene, frame, W, H, target=target)
    g_ref = g["materials.albedo"].cpu() * (H * W * 3)
    implied = (scene.materials.albedo - new.materials.albedo).cpu() / (1.0 / (H * W * 3))
    torch.testing.assert_close(float(loss), float(loss_ref), rtol=2e-2, atol=1e-5)
    torch.testing.assert_close(implied, g_ref, rtol=2e-2, atol=1e-5)
    assert float(g_ref.abs().max()) > 0
