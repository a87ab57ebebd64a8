"""The port's random streams (clraytracer_tpu_torch.ops.rng) against the
JAX package's ``ops/rng.py`` and ``render_pallas._gi_seed_rows`` on the
same seeded uint32 inputs: the integer parts bit for bit, the tangent
frame and the hemisphere sample to atol 1e-6 (their sqrt, cos and sin may
round differently); the host-side generators (``pixel_streams``,
``PCG32``, ``MTwister``, ``MTwister64``) draw for draw against the JAX
classes and against the reference's golden draws of tests/test_rng.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from clraytracer_tpu.ops import rng as jrng
from clraytracer_tpu.ops.render_pallas import _gi_seed_rows
from clraytracer_tpu_torch.ops import rng as trng
from _torch_threads import one_torch_thread  # noqa: F401

N = 4096


@pytest.fixture(scope="module")
def states():
    """Seeded uint32 values, the extremes included."""
    s = np.random.default_rng(7).integers(0, 2**32, N, dtype=np.uint64).astype(np.uint32)
    s[:4] = [0, 1, 0x7FFFFFFF, 0xFFFFFFFF]
    return s


def _t(u32: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(u32.astype(np.int64))


def _normals(seed: int) -> np.ndarray:
    v = np.random.default_rng(seed).standard_normal((3, N)).astype(np.float32)
    v[:, :8] = [[1, -1, 0.995, 0, 0, 1, 0.7, 0.99],
                [0, 0, 0.0998, 1, 0, 0, 0.7, 0.141],
                [0, 0, 0, 0, 1, 0, 0.1, 0]]  # near +-X: the helper switch
    return (v / np.linalg.norm(v, axis=0)).astype(np.float32)


def test_wang_hash_bit_exact(states):
    ref = np.asarray(jrng.wang_hash(jnp.asarray(states)))
    got = trng.wang_hash(_t(states)).numpy()
    assert got.min() >= 0 and got.max() < 2**32
    np.testing.assert_array_equal(got.astype(np.uint32), ref)


def test_xorshift32_bit_exact(states):
    ref = np.asarray(jrng.xorshift32(jnp.asarray(states)))
    got = trng.xorshift32(_t(states)).numpy()
    np.testing.assert_array_equal(got.astype(np.uint32), ref)


def test_next_float01_bit_exact(states):
    f_ref, s_ref = jrng.next_float01(jnp.asarray(states))
    f_got, s_got = trng.next_float01(_t(states))
    assert f_got.dtype == torch.float32
    np.testing.assert_array_equal(f_got.numpy(), np.asarray(f_ref))
    np.testing.assert_array_equal(s_got.numpy().astype(np.uint32), np.asarray(s_ref))
    assert 0.0 <= float(f_got.min()) and float(f_got.max()) < 1.0


@pytest.mark.parametrize("gi_seed", [0, 1, 12345, -3, 2**31 - 1])
def test_gi_seed_rows_bit_exact(gi_seed):
    """``1 + seed*7919 + b*1237`` in wrapping 32-bit arithmetic, as the
    JAX kernel's traced i32 row has it."""
    ref = np.asarray(_gi_seed_rows(gi_seed, 5)).reshape(-1).view(np.uint32)
    got = np.asarray(trng.gi_seed_rows(gi_seed, 5), np.uint64).astype(np.uint32)
    np.testing.assert_array_equal(got, ref)


def test_ray_streams_match_two_phase_seeding():
    """The per-ray stream of the two-phase path (render.py:255-261):
    wang_hash(ridx * 9999 + base) in uint32."""
    base = trng.gi_seed_rows(3, 2)[1]
    ridx = np.arange(N, dtype=np.uint32) + np.uint32(2**31 - 100)
    ref = np.asarray(jrng.wang_hash(jnp.asarray(ridx) * jnp.uint32(9999) + jnp.uint32(base)))
    got = trng.ray_streams(torch.from_numpy(ridx.astype(np.int64)), base).numpy()
    np.testing.assert_array_equal(got.astype(np.uint32), ref)


def test_tangent_space_matches():
    n = _normals(1)
    t_ref, b_ref = (np.asarray(x) for x in jrng.tangent_space(jnp.asarray(n)))
    t_got, b_got = trng.tangent_space(torch.from_numpy(n))
    np.testing.assert_allclose(t_got.numpy(), t_ref, rtol=0, atol=1e-6)
    np.testing.assert_allclose(b_got.numpy(), b_ref, rtol=0, atol=1e-6)


def test_hemisphere_sample_matches(states):
    n = _normals(2)
    d_ref, s_ref = jrng.hemisphere_sample(jnp.asarray(states), jnp.asarray(n))
    d_got, s_got = trng.hemisphere_sample(_t(states), torch.from_numpy(n))
    np.testing.assert_allclose(d_got.numpy(), np.asarray(d_ref), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(s_got.numpy().astype(np.uint32), np.asarray(s_ref))
    # on the normal's side, unit length
    assert (d_got * torch.from_numpy(n)).sum(dim=0).min() >= -1e-6
    np.testing.assert_allclose(torch.linalg.vector_norm(d_got, dim=0).numpy(), 1.0, atol=1e-5)


def test_fused_gi_sample_matches_hemisphere_sample(states):
    """The plain K2.2's continuation draws the JAX ``hemisphere_sample``'s
    direction flipped to the normal's side, with the weight 2 |cos theta|."""
    from clraytracer_tpu_torch.ops.render_fused import _gi_sample

    n = _normals(3)
    d_ref, _ = jrng.hemisphere_sample(jnp.asarray(states), jnp.asarray(n))
    d_ref = np.asarray(d_ref)
    dot = (d_ref * n).sum(axis=0)
    flipped = np.where(dot < 0, -d_ref, d_ref)
    nt = torch.from_numpy(n)
    d_got, w = _gi_sample([nt[0], nt[1], nt[2]], _t(states))
    np.testing.assert_allclose(torch.stack(d_got).numpy(), flipped, rtol=0, atol=1e-6)
    np.testing.assert_allclose(w.numpy(), 2.0 * np.abs(dot), rtol=0, atol=1e-6)


@pytest.mark.parametrize("w,h,frame", [(16, 16, 3), (1024, 512, 0), (1024, 512, 2**32 - 1)])
def test_pixel_streams_bit_exact(w, h, frame):
    """``wang_hash(i * 9999 + frame)`` in uint32: at 1024x512 the product
    passes 2^32 from pixel 429,540 on, and frame 2^32 - 1 wraps every sum."""
    ref = np.asarray(jrng.pixel_streams(w, h, frame))
    got = trng.pixel_streams(w, h, frame, device="cpu")
    assert got.shape == (h, w) and got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), ref)


@pytest.mark.parametrize("form", ["default", "seed", "seed_initstate", "lanes", "seed_lanes"])
def test_pcg32_lane_for_lane(form):
    """The three constructor forms, scalar and vectorised, 40 draws and the
    float draw, every lane equal."""
    lanes = np.arange(6, dtype=np.uint64) * np.uint64(0x9E3779B97F4A7C15) + np.uint64(1)
    kw = {"default": {}, "seed": {"seed": np.uint64(42)},
          "seed_initstate": {"seed": np.uint64(42), "initstate": np.uint64(12345)},
          "lanes": {"seed": lanes, "initstate": lanes[::-1].copy()},
          "seed_lanes": {"seed": lanes}}[form]
    a, b = trng.PCG32(**kw), jrng.PCG32(**kw)
    for _ in range(40):
        x, y = a.next(), b.next()
        assert x.dtype == y.dtype == np.uint32
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(a.state, b.state)
    np.testing.assert_array_equal(a.next_float01(), b.next_float01())


@pytest.mark.parametrize("cls,seed", [("MTwister", 4586), ("MTwister", 1), ("MTwister64", 4357),
                                      ("MTwister64", 1), ("MTwister64", 987654321)])
def test_mersenne_twisters_draw_for_draw(cls, seed):
    """1300 draws, across a refill of the 624-word state (and for
    MTwister64 its double-processed index 257 and the read one past the
    array), then ``next64`` across the next refill."""
    a, b = getattr(trng, cls)(seed), getattr(jrng, cls)(seed)
    assert [a.next() for _ in range(1300)] == [b.next() for _ in range(1300)]
    assert [a.next64() for _ in range(700)] == [b.next64() for _ in range(700)]


def test_mersenne_twisters_golden():
    """The reference's own draws (tests/test_rng.py's golden values, from
    Random.hpp compiled with g++), ``Next64``'s ``&`` combine included."""
    m = trng.MTwister()
    assert [m.next() for _ in range(4)] == [1586803154, 3398496343, 3681244880, 689747524]
    mb = trng.MTwister(123456789)
    assert [mb.next() for _ in range(4)] == [2288500408, 4254805660, 2294099250, 56498137]
    mc = trng.MTwister(77)
    assert [mc.next64() for _ in range(4)] == [0, 0, 0, 0]
    m6 = trng.MTwister64()
    assert [m6.next() for _ in range(4)] == [1464053668, 2092294200, 3487852631, 1350858567]
    m6b = trng.MTwister64(987654321)
    assert [m6b.next() for _ in range(4)] == [4076952483, 1994907941, 3747183639, 1822789853]
    m6c = trng.MTwister64(1)
    assert [m6c.next() for _ in range(1300)][-1] == 2325004920
    md = trng.MTwister(1)
    assert [md.next() for _ in range(1300)][-1] == 2604647584
