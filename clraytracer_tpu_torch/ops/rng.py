"""Per-ray random streams of the Monte-Carlo GI continuation: Wang-hash
seeding, xorshift32 steps, 24-bit uniform floats, the tangent frame and
uniform hemisphere sampling (MathAndSTL.cl:173-215; the JAX package's
``ops/rng.py``), and the per-bounce seed bases of the fused frame
(``render_pallas._gi_seed_rows``); ``pixel_streams``, the per-pixel states
of a frame; and the host-side generators of the reference's Random.hpp,
``PCG32``, ``MTwister`` and ``MTwister64``, bit-exact with the JAX
package's copies draw for draw.

torch has no uint32 arithmetic, so a stream state is an int64 tensor that
holds the uint32 value: every multiply and left shift is masked back to 32
bits, and every intermediate stays below 2^63 (the largest is a 32-bit
state times the 30-bit Wang constant). The bits equal the JAX package's
uint32 and the CUDA kernel's ``uint32_t``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from clraytracer_tpu_torch.device import resolve_device

_MASK = 0xFFFFFFFF
#: float multiplier for 24-bit mantissa uniforms (MathAndSTL.cl:127)
_FMUL = 1.0 / 16777216.0


def _u32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int64) & _MASK


def wang_hash(seed: torch.Tensor) -> torch.Tensor:
    """Wang integer hash (MathAndSTL.cl:189-195) of uint32 values held in
    an integer tensor → int64 tensor of uint32 values."""
    s = _u32(seed)
    s = (s ^ 61) ^ (s >> 16)
    s = (s * 9) & _MASK
    s = s ^ (s >> 4)
    s = (s * 0x27D4EB2D) & _MASK
    return s ^ (s >> 15)


def xorshift32(state: torch.Tensor) -> torch.Tensor:
    """One xorshift32 step: the new state, which is also the sample
    (MathAndSTL.cl:197-202)."""
    s = _u32(state)
    s = s ^ ((s << 13) & _MASK)
    s = s ^ (s >> 17)
    return s ^ ((s << 5) & _MASK)


def next_float01(state: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(uniform f32 in [0, 1) with 24-bit granularity, advanced state)
    (MathAndSTL.cl:204-206)."""
    s = xorshift32(state)
    return (s >> 8).to(torch.float32) * _FMUL, s


def pixel_streams(width: int, height: int, frame: int = 0,
                  device: str | torch.device | None = None) -> torch.Tensor:
    """Planar [H, W] stream states, decorrelated per pixel and frame (the
    per-thread ``WangHash(i * 9999 + time)`` idiom): int64 holding uint32
    values on ``device`` (None = the CUDA card). ``i * 9999 + frame`` wraps
    mod 2^32 as the JAX package's uint32 arithmetic does (from pixel
    429,540 on the product passes 2^32)."""
    idx = torch.arange(width * height, dtype=torch.int64, device=resolve_device(device))
    return wang_hash((idx * 9999 + (frame & _MASK)) & _MASK).reshape(height, width)


def tangent_space(normal: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(tangent, binormal) around planar normals [3, *S] (GetTangentSpace,
    MathAndSTL.cl:173-185): helper +X, or +Z where the normal is nearly +X.
    In csrc/render.cu's expression order: the cross products without their
    zero terms, each scaled by the reciprocal of its length."""
    nx, ny, nz = normal[0], normal[1], normal[2]
    near_x = nx.abs() > 0.99
    one, zero = torch.ones_like(nx), torch.zeros_like(nx)
    hx = torch.where(near_x, zero, one)
    hz = torch.where(near_x, one, zero)
    tx, ty, tz = ny * hz, nz * hx - nx * hz, -ny * hx
    tn = 1.0 / torch.sqrt(tx * tx + ty * ty + tz * tz)
    tx, ty, tz = tx * tn, ty * tn, tz * tn
    bx, by, bz = ny * tz - nz * ty, nz * tx - nx * tz, nx * ty - ny * tx
    bn = 1.0 / torch.sqrt(bx * bx + by * by + bz * bz)
    return torch.stack([tx, ty, tz]), torch.stack([bx * bn, by * bn, bz * bn])


def hemisphere_sample(
    state: torch.Tensor, normal: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Uniform-in-cosTheta hemisphere directions about planar normals
    [3, *S] (HemisphereSample, MathAndSTL.cl:208-215) → ([3, *S]
    directions, advanced state), in csrc/render.cu's expression order."""
    cos_theta, state = next_float01(state)
    u, state = next_float01(state)
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    phi = (2.0 * math.pi) * u
    px = torch.cos(phi) * sin_theta
    py = torch.sin(phi) * sin_theta
    tangent, binormal = tangent_space(normal)
    d = torch.stack(
        [tangent[c] * px + binormal[c] * py + normal[c] * cos_theta for c in range(3)]
    )
    return d, state


def gi_seed_rows(gi_seed: int, bounces: int) -> list[int]:
    """Per-bounce seed bases ``1 + gi_seed*7919 + b*1237`` in wrapping
    32-bit arithmetic, as uint32 values (render_pallas._gi_seed_rows; its
    i32 wrap has the same bits). The CUDA kernel takes bounce 0's base and
    adds 1237 per bounce in ``uint32_t``, which wraps the same way."""
    return [(1 + gi_seed * 7919 + b * 1237) & _MASK for b in range(bounces)]


def ray_streams(ray_index: torch.Tensor, seed_base: int) -> torch.Tensor:
    """The GI stream state of each ray at one bounce:
    ``wang_hash(i * 9999 + base)`` of its strip-order index ``i``
    (render.py:255-261 of the JAX package, the fused kernel's
    ``row*128 + lane``)."""
    return wang_hash((_u32(ray_index) * 9999 + seed_base) & _MASK)


# ---------------------------------------------------------------------------
# host-side generators of the reference (Random.hpp), in numpy as the JAX
# package keeps them: their 64-bit states wrap, which numpy's uint64 does by
# definition and torch's int64 would do only through signed overflow
# ---------------------------------------------------------------------------


class PCG32:
    """Host-side PCG32, bit-exact with the reference's ``Random::PCG``
    (Random.hpp:106-138; the standard pcg32 from pcg-random.org),
    vectorised over numpy uint64 state arrays: every lane an independent
    stream.

    Constructor forms mirror the reference: ``PCG32()`` (default state),
    ``PCG32(seed)`` (Random.hpp:114-117: default state, inc = seed << 1 |
    1), ``PCG32(seed, initstate)`` (Random.hpp:119-125: the canonical
    pcg32_srandom)."""

    _MUL = 6364136223846793005
    _STATE = 0x853C49E6748FEA9B
    _INC = 0xDA3E39CB94B95BDB

    def __init__(self, seed=None, initstate=None):
        if seed is None:
            self.state = np.asarray(self._STATE, np.uint64)
            self.inc = np.asarray(self._INC, np.uint64)
            return
        inc = (np.asarray(seed, np.uint64) << np.uint64(1)) | np.uint64(1)
        if initstate is None:
            self.state = np.full(np.shape(seed), self._STATE, np.uint64)
            self.inc = inc
            return
        self.state = np.zeros_like(np.asarray(seed, np.uint64))
        self.inc = inc
        self.next()
        self.state = self.state + np.asarray(initstate, np.uint64)
        self.next()

    def next(self):
        """One pcg32 step → uint32 sample(s) (Random.hpp:130-138)."""
        old = self.state
        with np.errstate(over="ignore"):
            self.state = old * np.uint64(self._MUL) + (self.inc | np.uint64(1))
        xorshifted = ((old >> np.uint64(18)) ^ old) >> np.uint64(27)
        rot = (old >> np.uint64(59)).astype(np.uint32)
        x32 = xorshifted.astype(np.uint32)
        with np.errstate(over="ignore"):
            return (x32 >> rot) | (x32 << ((-rot) & np.uint32(31)))

    def next_float01(self):
        """float(Next() >> 8) / 2^24 (Random.hpp:82)."""
        return (self.next() >> np.uint32(8)).astype(np.float32) * np.float32(_FMUL)


class MTwister:
    """Host-side Mersenne Twister, bit-exact with the reference's 32-bit
    ``Random::MTwister`` (Random.hpp:231-330): the MT19937 layout (SIZE
    624, PERIOD 397, init 0x6c078965, the standard tempering), and the
    reference's ``Next64``, which combines its two draws with ``&`` where
    ``|`` was meant (Random.hpp:270): the 64-bit stream is reproduced as
    shipped, mostly zeros."""

    _SIZE, _PERIOD = 624, 397
    _MAGIC = 0x9908B0DF

    def __init__(self, seed: int = 4586):
        mt = np.empty(self._SIZE, np.uint32)
        mt[0] = np.uint32(seed)
        with np.errstate(over="ignore"):
            for i in range(1, self._SIZE):
                mt[i] = np.uint32(0x6C078965) * (mt[i - 1] ^ (mt[i - 1] >> np.uint32(30))) \
                    + np.uint32(i)
        self._mt = mt
        self._index = self._SIZE

    def _generate(self) -> None:
        mt = self._mt
        size, period = self._SIZE, self._PERIOD
        for i in range(size):
            y = (np.uint32(0x80000000) & mt[i]) | (np.uint32(0x7FFFFFFF) & mt[(i + 1) % size])
            sel = np.uint32(0xFFFFFFFF) if (y & np.uint32(1)) else np.uint32(0)
            mt[i] = mt[(i + period) % size] ^ (y >> np.uint32(1)) ^ (sel & np.uint32(self._MAGIC))
        self._index = 0

    def next(self) -> int:
        if self._index >= self._SIZE:
            self._generate()
        y = self._mt[self._index]
        self._index += 1
        y ^= y >> np.uint32(11)
        y ^= (y << np.uint32(7)) & np.uint32(0x9D2C5680)
        y ^= (y << np.uint32(15)) & np.uint32(0xEFC60000)
        y ^= y >> np.uint32(18)
        return int(y)

    def next64(self) -> int:
        """``a & (b << 32)`` of two draws, tempered with the masks ANDed
        with themselves shifted, as Random.hpp:265-278 ships it: the low
        word is always zero, so the values are almost always 0."""
        if self._index + 1 >= self._SIZE:
            self._generate()
        a = np.uint64(self._mt[self._index])
        self._index += 1
        b = np.uint64(self._mt[self._index])
        self._index += 1
        y = a & (b << np.uint64(32))
        y ^= y >> np.uint64(11)
        y ^= (y << np.uint64(7)) & np.uint64(0x9D2C5680 & (0x9D2C5680 << 32))
        y ^= (y << np.uint64(15)) & np.uint64(0xEFC60000 & (0xEFC60000 << 32))
        y ^= y >> np.uint64(18)
        return int(y)


class MTwister64:
    """Host-side twin of the reference's nonstandard 64-bit ``MTwister64``
    (Random.hpp:158-230): a 624-word uint64 state, M = 367 (not
    MT19937-64's 156), multiplicative 69069 seeding with no tempering
    mask, 32-bit mixing masks applied to 64-bit words, and ``Next() =
    uint32(x >> 16)``.

    The refill keeps both of the reference's off-spec behaviours:

    * index 257 is processed twice: the first loop, unrolled by 3 (``while
      kk < N - M`` with N - M = 257), overruns to kk = 257, then ``kk--``
      lets the second loop redo it (Random.hpp:196-208);
    * that overrun reads ``m_MT[624]``, one past the array, which is
      ``m_Index`` (624 or 625). Only bit 31 of that word can reach later
      state (through index 257's redone ``y``), and it is always 0, so the
      sequence is deterministic; the word is modelled as ``m_Index``'s
      value."""

    _N, _M = 624, 367
    _MAGIC = 0x9908B0DF

    def __init__(self, seed: int = 4357):
        mt = np.empty(self._N, np.uint64)
        mt[0] = np.uint64(seed)
        with np.errstate(over="ignore"):
            for i in range(1, self._N):
                mt[i] = np.uint64(69069) * mt[i - 1]
        self._mt = mt
        self._index = self._N + 1

    def _generate(self) -> None:
        mt = self._mt
        n, m = self._N, self._M
        magic, one = np.uint64(self._MAGIC), np.uint64(1)
        hi, lo = np.uint64(0x80000000), np.uint64(0x7FFFFFFF)

        def mix(kk: int, base: int) -> None:
            y = (mt[kk] & hi) | (mt[kk + 1] & lo)
            sel = magic if (y & one) else np.uint64(0)
            src = np.uint64(self._index) if base == n else mt[base]  # m_MT[624] is m_Index
            mt[kk] = src ^ (y >> one) ^ sel

        kk = 0
        while kk < n - m:  # unrolled by 3 in the reference: overruns to 257
            for _ in range(3):
                mix(kk, kk + m)
                kk += 1
        kk -= 1  # 257 redone below, as in the reference
        while kk < n - 1:
            for _ in range(3):
                mix(kk, kk + m - n)
                kk += 1
        y = (mt[n - 1] & hi) | (mt[0] & lo)
        sel = magic if (y & one) else np.uint64(0)
        mt[n - 1] = mt[m - 1] ^ (y >> one) ^ sel
        self._index = 0

    def next(self) -> int:
        if self._index >= self._N:
            self._generate()
        x = self._mt[self._index]
        self._index += 1
        x ^= x >> np.uint64(11)
        x ^= (x << np.uint64(7)) & np.uint64(0x9D2C5680)
        x ^= (x << np.uint64(15)) & np.uint64(0xEFC60000)
        x ^= x >> np.uint64(18)
        return int(np.uint32(x >> np.uint64(16)))

    def next64(self) -> int:
        """``Next() >> 16``, as shipped (Random.hpp:185)."""
        return self.next() >> 16
