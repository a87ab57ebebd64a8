"""K2.2's split-rebin carry on the CPU: ``render_fused_camera(split_rebin=
True)`` (bounce 0 with the live rays' state and a per-ray ``rebin_key``
carried out, one stable sort of the keys, the remaining bounces resumed
over the live rays in key order and written back in place) through the
plain versions, against the unsplit frame bit for bit and against the JAX
package's split frame (its fused kernel in Pallas interpret mode); the
re-bin key and the per-ray key plane against JAX's ``rebin_key``; the
carry-in's independence of the order it walks in; the split's gate; the
carry's arguments; and the ``row0``/``local_height`` row windows.

The plain K2.2 traces each ray by brute force, so the split cannot change
a ray's hit: the carried f32 state round-trips exactly and the split
frame equals the unsplit one bit for bit. Against JAX the tolerance is
tests/test_torch_raymode.py's: at least 99% of rays within 1e-5.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from clraytracer_tpu.camera import Camera as JCamera
from clraytracer_tpu.config import CameraConfig as JCameraConfig
from clraytracer_tpu.ops import render_pallas as jrp
from clraytracer_tpu.render import frame_inputs_from_camera as j_frame_inputs
import chip_smoke as cs
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from clraytracer_tpu_torch import render as trender
from clraytracer_tpu_torch.camera import Camera as TCamera
from clraytracer_tpu_torch.config import CameraConfig as TCameraConfig
from clraytracer_tpu_torch.ops import render_fused as rf
from clraytracer_tpu_torch.ops import trace as tr
from clraytracer_tpu_torch.scene.bridge import scene_from_numpy
from test_torch_options import _ground_scene
from test_torch_scene import flatten

BENCH = ((0.13, 0.21, 10.0), 0.0, -1.96)
GROUND = ((0.3, 4.0, 7.0), -28.0, -np.pi / 2)  # test_shadows.py:38-44
_built: dict = {}


def scenes(name, request):
    """(JAX scene, the port's copy through the bridge), built once."""
    if name not in _built:
        js = (request.getfixturevalue(name) if name.endswith("_scene")
              else _ground_scene(False))
        _built[name] = (js, scene_from_numpy(*flatten(js), device="cpu"))
    return _built[name]


def view(name):
    return GROUND if name == "ground" else BENCH


def port_inputs(name, w, h):
    pos, pitch, sun = view(name)
    cam = TCamera.create(TCameraConfig(position=pos, pitch_deg=pitch), w, h)
    return trender.frame_inputs_from_camera(cam, sun)


def counting_plain(monkeypatch):
    """Stand a recorder in for the plain K2.2: its keyword arguments and
    bounces, per call."""
    calls = []
    plain = rf.render_fused_plain

    def rec(*a, **k):
        calls.append(dict(k, bounces=a[7]))
        return plain(*a, **k)

    monkeypatch.setattr(rf, "render_fused_plain", rec)
    return calls


def test_rebin_key_matches_jax():
    """Integer-exact on seeded per-row means: octants from exact zeros and
    both signs of sign(d)'s mean, origin cells from negative values and
    |o| past 4096 (where an f32 key would lose cells)."""
    g = np.random.default_rng(7)
    rows = 4096
    dm = g.choice(np.float32([-1.0, -0.5, -1 / 128, 0.0, 1 / 128, 0.25, 1.0]), (3, rows))
    dm = dm.astype(np.float32)
    om = np.concatenate([
        g.uniform(-20.0, 20.0, (3, rows // 2)),
        g.uniform(-1e6, 1e6, (3, rows // 2)),
    ], axis=1).astype(np.float32)
    om[:, :16] = np.float32([-4096.25, -4.0, -0.0])[:, None]  # floor edges
    ref = np.asarray(jrp.rebin_key(tuple(jnp.asarray(x) for x in dm),
                                   tuple(jnp.asarray(x) for x in om)))
    got = rf.rebin_key(torch.from_numpy(dm), torch.from_numpy(om))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    assert (np.abs(om) > 4096).any() and (dm == 0).any() and len(np.unique(ref)) > 100


SPLIT_CASES = [
    ("procedural_scene", 32, 24, False, 2),
    ("procedural_scene", 64, 48, False, 2),
    ("procedural_scene", 32, 24, False, 3),
    ("ground", 32, 24, False, 2),
    ("ground", 32, 24, True, 2),
    ("ground", 64, 48, False, 2),
    ("ground", 64, 48, True, 2),
]


@pytest.mark.parametrize("name,w,h,shadows,bounces", SPLIT_CASES,
                         ids=[f"{n}-{w}x{h}-{'shadows' if s else 'plain'}-b{b}"
                              for n, w, h, s, b in SPLIT_CASES])
def test_plain_split_equals_unsplit(name, w, h, shadows, bounces, request, monkeypatch):
    """The plain split frame (carry-out launch, key sort, carry-in launch at
    global bounce 1, in place) equals the plain unsplit frame bit for bit,
    with shadows on and off and over 3 bounces. The procedural scene's
    bounce-0 warps mix live and dead lanes, and some are wholly dead; the
    stable sort puts the live keys first, in order, ties in thread order,
    so that only as many warps as the live rays fill walk bounce 1."""
    ts = scenes(name, request)[1]
    frame = port_inputs(name, w, h)
    calls = counting_plain(monkeypatch)
    one, lay1 = rf.render_fused_camera(ts, frame, w, h, bounces, enable_shadows=shadows,
                                       split_rebin=False)
    assert len(calls) == 1 and not calls[0].get("carry_out")
    split, lay2 = rf.render_fused_camera(ts, frame, w, h, bounces, enable_shadows=shadows,
                                         split_rebin=True)
    assert lay1 == lay2
    first, second = calls[1:]
    assert first["carry_out"] and first["bounces"] == 1 and "rays" not in first
    assert second["start_bounce"] == 1 and second["bounces"] == bounces - 1
    keys, order = second["keys"], second["order"]
    assert second["carry"].shape == (rf.CARRY_PLANES, keys.shape[0]) and "rays" not in second
    np.testing.assert_array_equal(split.numpy(), one.numpy())
    # the key plane in thread order: 32 keys a bounce-0 warp
    warps = (second["carry"][rf.CARRY_PLANES - 1].view(torch.int32) != rf.KEY_DEAD)
    warps = warps.reshape(-1, 32)
    if name == "procedural_scene":
        assert (~warps.any(dim=1)).any()  # wholly dead warps
        assert (warps.any(dim=1) & ~warps.all(dim=1)).any()  # mixed warps
    live = keys != rf.KEY_DEAD
    tie = keys[1:] == keys[:-1]
    assert (keys[1:] >= keys[:-1]).all() and (order[1:][tie] > order[:-1][tie]).all()
    assert int(live.reshape(-1, 32).any(dim=1).sum()) == -(-int(live.sum()) // 32)
    assert int(live.sum()) == int(warps.sum())


def test_split_matches_jax_split(request):
    """The port's split frame against the JAX package's
    ``render_fused_camera(split_rebin=True)`` (Pallas interpret mode) on
    the two-instance procedural scene at 32x24: at least 99% of rays
    within 1e-5 (the per-row means may round apart and give another row
    order; the frame does not depend on it)."""
    js, ts = scenes("procedural_scene", request)
    w, h = 32, 24
    pos, _pitch, sun = BENCH
    jframe = j_frame_inputs(JCamera.create(JCameraConfig(position=pos), w, h), sun)
    ref, jlay = jrp.render_fused_camera(js, jframe, w, h, 2, split_rebin=True)
    ref = np.asarray(ref)
    got, lay = rf.render_fused_camera(ts, port_inputs("procedural_scene", w, h), w, h, 2,
                                      split_rebin=True)
    assert tuple(jlay) == lay and got.shape == ref.shape
    got = got.numpy()
    assert np.isfinite(got).all()
    close = (np.abs(got - ref) <= 1e-5).all(axis=0)
    print(f"split: {int((~close).sum())} of {close.size} rays off by > 1e-5")
    assert close.mean() >= 0.99, close.mean()
    assert (got > 0.0).any(axis=0).mean() > 0.5


GATE_CASES = [
    ("gi", "procedural_scene", dict(gi_seed=3, split_rebin=True)),
    ("atlas", "sphere_scene", dict(split_rebin=True)),
    ("one-bounce", "procedural_scene", dict(bounces=1, split_rebin=True)),
    ("auto", "procedural_scene", dict(split_rebin=None)),
    ("auto-shadows", "ground", dict(enable_shadows=True)),
]


@pytest.mark.parametrize("label,name,kw", GATE_CASES, ids=[c[0] for c in GATE_CASES])
def test_split_gate_runs_one_launch(label, name, kw, request, monkeypatch):
    """JAX's gate (render_pallas.py:1288-1291): the split is taken only for
    ``bounces >= 2`` in atlas mode 0 without GI, and ``split_rebin=None``
    asks ``split_rebin_preferred``, off for every scene. Elsewhere one
    plain call, with no carry, makes the frame."""
    ts = scenes(name, request)[1]
    assert not rf.split_rebin_preferred(ts)
    w, h = 32, 24
    kw = dict(kw)
    bounces = kw.pop("bounces", 2)
    calls = counting_plain(monkeypatch)
    img, _lay = rf.render_fused_camera(ts, port_inputs(name, w, h), w, h, bounces, **kw)
    assert len(calls) == 1 and calls[0]["bounces"] == bounces
    assert not calls[0].get("carry_out") and calls[0].get("carry") is None
    assert torch.isfinite(img).all()


def test_carry_out_planes_hold_the_continuation_state(request):
    """carry_out appends o | d | energy of the rays still alive and the key
    plane after the 9 planes, which equal the launch's without it: lanes
    that hit leave from the offset hit point with the reflected direction
    and light 0.2 * spec_s, and key as ``rebin_key`` of that origin and
    direction; lanes that missed key ``KEY_DEAD`` (the plain version zeroes
    their continuation, which the kernel leaves unwritten)."""
    ts = scenes("procedural_scene", request)[1]
    w, h = 64, 48
    args = cs.option_args(ts, port_inputs("procedural_scene", w, h), w, h, bounces=1)
    cpu = torch.device("cpu")
    plain = rf.render_fused_plain(*args, cpu)
    out = rf.render_fused_plain(*args, cpu, carry_out=True)
    assert out.shape == (rf.CARRY_PLANES, args[6] * 128)
    np.testing.assert_array_equal(out[:9].numpy(), plain.numpy())
    rays, _cam = cs.camera_rays(w, h, cpu, port_inputs("procedural_scene", w, h))
    hit = tr.trace_plain(args[0], rays)[0] < tr.BIG
    key = rf.keys_by_ray(out)
    assert torch.equal(key != rf.KEY_DEAD, hit) and 0 < int(hit.sum()) < hit.numel()
    assert (out[9:18][:, ~hit] == 0.0).all()
    assert (out[9:12][:, hit] != rays[0:3][:, hit]).any(dim=0).all()
    assert (out[15:18][:, hit] < 1.0).all()
    assert torch.equal(key[hit], rf.rebin_key(out[12:15][:, hit], out[9:12][:, hit]))


def test_key_plane_matches_jax_rebin_key(request):
    """The plain carry-out's key plane, in ray order, equals JAX
    ``rebin_key`` of the same per-ray directions and origins where the ray
    is alive, ``KEY_DEAD`` elsewhere; and ``ray_keys`` equals it on seeded
    per-ray arrays with exact zeros and both signs in the direction and
    origins past 4096, all exactly."""
    ts = scenes("procedural_scene", request)[1]
    w, h = 64, 48
    args = cs.option_args(ts, port_inputs("procedural_scene", w, h), w, h, bounces=1)
    out = rf.render_fused_plain(*args, torch.device("cpu"), carry_out=True)
    key = rf.keys_by_ray(out).numpy()
    o, d = out[9:12].numpy(), out[12:15].numpy()
    ref = np.asarray(jrp.rebin_key(tuple(jnp.asarray(x) for x in d),
                                   tuple(jnp.asarray(x) for x in o)))
    live = key != rf.KEY_DEAD
    np.testing.assert_array_equal(key, np.where(live, ref, rf.KEY_DEAD))
    assert live.any() and (~live).any()
    g = np.random.default_rng(11)
    n = 4096
    d = g.choice(np.float32([-1.0, -0.25, -0.0, 0.0, 1e-30, 0.5, 1.0]), (3, n))
    o = np.concatenate([g.uniform(-20.0, 20.0, (3, n // 2)),
                        g.uniform(-1e6, 1e6, (3, n // 2))], axis=1).astype(np.float32)
    o[:, :8] = np.float32([-4096.25, -4.0, -0.0])[:, None]  # floor edges
    alive = g.random(n) < 0.7
    ref = np.asarray(jrp.rebin_key(tuple(jnp.asarray(x) for x in d.astype(np.float32)),
                                   tuple(jnp.asarray(x) for x in o)))
    got = rf.ray_keys(list(torch.from_numpy(o)), list(torch.from_numpy(d.astype(np.float32))),
                      torch.from_numpy(alive))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.where(alive, ref, rf.KEY_DEAD))


def test_plain_carry_in_is_order_free(request):
    """The plain carry-in over 2 bounces from one carry-out, through the
    sorted keys, a seeded shuffle of them and ray order, each in place on
    its own copy of the buffer: the three buffers are bit-equal, and only
    the frame planes of the live rays changed."""
    ts = scenes("procedural_scene", request)[1]
    w, h = 64, 48
    args = cs.option_args(ts, port_inputs("procedural_scene", w, h), w, h, bounces=1)
    cpu = torch.device("cpu")
    first = rf.render_fused_plain(*args, cpu, carry_out=True)
    n = first.shape[1]
    tkeys = first[rf.CARRY_PLANES - 1].view(torch.int32)
    shuffle = torch.from_numpy(np.random.default_rng(5).permutation(n))
    by_ray = torch.argsort(rf.thread_rays(n, cpu))  # the thread of each ray
    orders = [rf.sort_keys(first), (tkeys[shuffle], shuffle), (rf.keys_by_ray(first), by_ray)]
    outs = []
    for keys, order in orders:
        buf = first.clone()
        got = rf.render_fused_plain(*args[:7], 2, cpu, carry=buf, keys=keys.contiguous(),
                                    order=order.contiguous(), start_bounce=1)
        assert got.data_ptr() == buf.data_ptr()  # in place
        outs.append(buf)
    for buf in outs[1:]:
        np.testing.assert_array_equal(buf.view(torch.int32).numpy(),
                                      outs[0].view(torch.int32).numpy())
    live = rf.keys_by_ray(first) != rf.KEY_DEAD
    changed = (outs[0][:9] != first[:9]).any(dim=0)
    assert changed.any() and not changed[~live].any()
    assert torch.equal(outs[0][9:].view(torch.int32), first[9:].view(torch.int32))


def test_plain_split_equals_unsplit_on_field(monkeypatch):
    """``field`` (36 spheres of 960 triangles in one mesh, the
    mixed-surface procedural class JAX keeps the split for) at 32x24: the
    plain split frame in two launches equals the plain unsplit frame bit
    for bit, and some of its rays go on past bounce 0."""
    from clraytracer_tpu_torch.cli import build_scene

    ts = build_scene("field", device="cpu")
    w, h = 32, 24
    frame = port_inputs("procedural_scene", w, h)
    calls = counting_plain(monkeypatch)
    one, lay1 = rf.render_fused_camera(ts, frame, w, h, 2, split_rebin=False)
    split, lay2 = rf.render_fused_camera(ts, frame, w, h, 2, split_rebin=True)
    assert lay1 == lay2 and len(calls) == 3 and calls[1]["carry_out"]
    np.testing.assert_array_equal(split.numpy(), one.numpy())
    assert (calls[2]["keys"] != rf.KEY_DEAD).any() and int(ts.tris.count) > 30000


def test_carry_arguments_are_checked():
    """The carry's arguments (``check_carry``): a carry resumes from its own
    rays at start_bounce >= 1 with its sorted keys ([n] i32) and their
    order ([n] int64); carry_out is camera mode at bounce 0; both take
    atlas mode 0 without GI and whole blocks of 512 rays; the carry is a
    contiguous [19, n] f32 tensor. The kernel wrapper refuses them too, and
    CPU tensors, launching nothing."""
    n = 512
    carry = torch.zeros(rf.CARRY_PLANES, n)
    keys, order = torch.zeros(n, dtype=torch.int32), torch.arange(n)
    ok = dict(atlas_mode=0, gi=False, rays=None, carry_out=False, carry=carry,
              start_bounce=1, keys=keys, order=order)
    rf.check_carry(n, **ok)
    rf.check_carry(n, 0, False, None, True, None, 0)
    rf.check_carry(256, 2, True, torch.zeros(6, 256), False, None, 0)  # no carry: anything
    bad = [
        dict(ok, atlas_mode=1), dict(ok, gi=True), dict(ok, rays=torch.zeros(6, n)),
        dict(ok, start_bounce=0), dict(ok, carry_out=True),
        dict(ok, carry=carry[:18].contiguous()), dict(ok, carry=carry.double()),
        dict(ok, carry=torch.zeros(n, rf.CARRY_PLANES).t()),
        dict(ok, carry=None, start_bounce=2),
        dict(ok, carry=None, carry_out=True, start_bounce=0),  # carry-out with keys
        dict(ok, keys=None), dict(ok, order=None), dict(ok, keys=keys.long()),
        dict(ok, order=order.int()), dict(ok, keys=keys[:256]),
        dict(atlas_mode=0, gi=False, rays=torch.zeros(6, n), carry_out=True, carry=None,
             start_bounce=0),  # carry-out with rays
    ]
    with pytest.raises(ValueError):  # not whole blocks of 512
        rf.check_carry(256, 0, False, None, True, None, 0)
    for kw in bad:
        with pytest.raises(ValueError):
            rf.check_carry(n, **kw)
    ts = cs.option_scene("ground", device="cpu")
    args = cs.option_args(ts, port_inputs("ground", 32, 24), 32, 24)
    before = (rf.render_cuda.launches, dict(rf.render_cuda.variant_launches))
    with pytest.raises(ValueError):
        rf.render_cuda(*args, carry_out=True)
    with pytest.raises(ValueError):
        rf.render_fused_plain(*args, torch.device("cpu"), carry_out=True, gi_seed=2)
    assert (rf.render_cuda.launches, rf.render_cuda.variant_launches) == before


@pytest.mark.parametrize("split", [False, True], ids=["unsplit", "split"])
def test_row_windows_stack_to_the_full_frame(split, request):
    """``row0``/``local_height``: rows 0-7, 8-15 and 16-23 of a 32x24
    frame, each rendered alone (its own strips, the unprojection over the
    full height) and untiled, stack to the full frame bit for bit; row0 as
    an int or a tensor."""
    ts = scenes("procedural_scene", request)[1]
    w, h, win = 32, 24, 8
    frame = port_inputs("procedural_scene", w, h)
    full, lay = rf.render_fused_camera(ts, frame, w, h, 2, split_rebin=split)
    want = rf.untile(full, ("strip",) + lay, h, w)
    parts = []
    for k, y0 in enumerate(range(0, h, win)):
        row0 = y0 if k % 2 == 0 else torch.tensor(y0)
        img, wlay = rf.render_fused_camera(ts, frame, w, h, 2, row0=row0, local_height=win,
                                           split_rebin=split)
        assert wlay == (8, 1, 1) and img.shape == (3, 8, 128)
        parts.append(rf.untile(img, ("strip",) + wlay, win, w))
    got = torch.cat(parts, dim=1)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert rf.camera_row(frame, 16).cam[35] == 16.0 and rf.camera_row(frame).cam[35] == 0.0


def test_chip_smoke_names_and_bounds_the_carry_instantiations():
    """k22_registers reads the carry instantiations' ptxas names (and the
    names without the carry parameter); variant_bound counts the carry's
    bytes: carry-out the 9 frame planes and the key of every ray (40 B a
    ray) and the 9 continuation planes of a live one (36 B); carry-in (one
    bounce) the sorted keys (4 B a ray), then a live ray's int64 order
    entry (8 B), o, d, energy and result in (48 B) and result out (12 B),
    and the 6 miss planes of a live ray that misses (24 B)."""
    regs = cs.k22_registers([
        {"kernel": "_Z13render_kernelILi0ELb0ELb0ELi0EEv11SceneTables12RenderParamsPfPy",
         "registers": 126, "spill_stores": 0, "spill_loads": 0},
        {"kernel": "_Z13render_kernelILi0ELb0ELb0ELi1EEv11SceneTables12RenderParamsPfPy",
         "registers": 127, "spill_stores": 0, "spill_loads": 0},
        {"kernel": ("_Z20render_shadow_kernelILi0ELb0ELb0ELi1EEv11SceneTables12"
                    "RenderParamsPfPyS2_"),
         "registers": 131, "spill_stores": 0, "spill_loads": 0},
        {"kernel": "_Z13render_kernelILi0ELb0ELb1ELi2EEv11SceneTables12RenderParamsPfPy",
         "registers": 128, "spill_stores": 0, "spill_loads": 0},
        {"kernel": "_Z13render_kernelILi1ELb0ELb1EEv11SceneTables12RenderParamsPfPy",
         "registers": 127, "spill_stores": 4, "spill_loads": 4},
    ])
    assert {k: v["registers"] for k, v in regs.items()} == {
        "default": 126, "carry_out": 127, "carry_out+shadows": 131, "rays+carry_in": 128,
        "rays+atlas1": 127}
    ts = cs.option_scene("ground", device="cpu")
    kt, ft = tr.kernel_tables(ts), tr.frame_tables(ts)
    n, live, hits = 1920 * 1088, 90_000, 60_000
    counts = [0, 0, 0, 0, 0, 0]  # bytes alone
    base = cs.walk_bytes(kt, 3, 40, ft)
    plain = cs.variant_bound(kt, ft, counts, 3, 40, n, 1, 0, False)
    out = cs.variant_bound(kt, ft, counts, 3, 40, n, 1, 0, False, carry="out", live=live)
    cin = cs.variant_bound(kt, ft, [0, 0, 0, hits, 0, 0], 3, 40, n, 1, 0, False, rays=True,
                           carry="in", live=live)
    assert (plain["bytes"] - base, out["bytes"] - base, cin["bytes"] - base) == (
        36 * n, 40 * n + 36 * live, 4 * n + 68 * live + 24 * (live - hits))
    assert out["output_planes"] == 19 and cin["output_planes"] == 9
    assert out["operations"] == plain["operations"] == n * cs.RAYGEN_OPS
    assert cin["operations"] == hits * (cs.INTERP_OPS + cs.SHADE_OPS)
    with pytest.raises(ValueError):  # the carry-in's misses are counted for one bounce
        cs.variant_bound(kt, ft, counts, 3, 40, n, 2, 0, False, rays=True, carry="in",
                         live=live)
