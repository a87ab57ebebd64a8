"""The CUDA kernels of clraytracer_tpu_torch against their plain PyTorch
versions on the card, and the wrappers' refusal of what they do not take.

Imports neither JAX nor the JAX package, so it also runs on a machine
without them:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

The tests marked ``cuda`` need an NVIDIA card (the kernels have no CPU
build) and skip without one.
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
# ``sphere`` at 70k triangles: three hyper groups of superclusters
SCENES = [("two", 4096), ("sphere", 4096), ("sphere", 70000)]
#: K2.2 and render_fused_plain agree exactly by construction (same slot
#: order, strict t < best); at most this many rays may differ
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


@pytest.mark.cuda
@pytest.mark.parametrize("spec,tris", SCENES)
def test_trace_kernel_matches_plain_on_card(spec, tris):
    """K2.1 against trace_plain on the same card: the hit rule of
    tests/test_trace.py, then the attributes wherever both pick the same
    slot (rtol 1e-5, atol 1e-6)."""
    dev = _card()
    kt = tr.kernel_tables(build_scene(spec, tris, device=dev))
    rays = _camera_rays(dev)
    live = (torch.arange(rays.shape[1], device=dev) % 3 != 0).float()
    for lv in (None, live):
        got = tr.trace_cuda(kt, rays, lv)
        ref = tr.trace_plain(kt, rays, lv)
        torch.cuda.synchronize()
        hit_g, hit_r = got[0].abs() < tr.BIG, ref[0].abs() < tr.BIG
        assert (hit_g != hit_r).sum().item() <= max(1, 0.01 * rays.shape[1])
        both = hit_g & hit_r
        assert both.sum().item() > 100
        same = both & (got[3].view(torch.int32) == ref[3].view(torch.int32))
        assert same.sum().item() > 0.98 * both.sum().item()
        torch.testing.assert_close(got[:, same], ref[:, same], rtol=1e-5, atol=1e-6)
        if lv is not None:
            assert (got[0][lv == 0] == -tr.BIG).all()


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
    """The optional int64[4] counters: boxes, triangles (32 per accepted
    cluster), ray transforms (one per instance per traversal) and hits;
    a launch without them counts nothing."""
    dev = _card()
    scene = build_scene("two", device=dev)
    kt = tr.kernel_tables(scene)
    rays = _camera_rays(dev)
    n = rays.shape[1]
    cnt = torch.zeros(4, dtype=torch.int64, device=dev)
    out = tr.trace_cuda(kt, rays, None, cnt)
    boxes, tris, xforms, hits = cnt.tolist()
    assert xforms == n * kt.n_inst
    assert hits == int((out[0].abs() < tr.BIG).sum())
    assert tris % 32 == 0 and boxes >= xforms and tris > 0
    cnt2 = torch.zeros(4, dtype=torch.int64, device=dev)
    args = _frame_args(scene)
    rf.render_cuda(*args, cnt2)
    rows = args[6] * 128
    assert rows * kt.n_inst <= cnt2[2].item() <= 2 * rows * kt.n_inst
    assert cnt2[3].item() <= 2 * rows


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
