"""The port's row gather and its transpose (the plain versions of K2.3 and
K2.4, and ``TakeRows`` around them) against the JAX package's
``gather.take_rows`` and its VJP, and against the TPU kernel
``gather_pallas.take_rows_mxu`` in interpret mode, on numpy-seeded inputs.
Everything runs on the CPU."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clraytracer_tpu.ops import gather as jgather
from clraytracer_tpu.ops.gather_pallas import take_rows_mxu
from clraytracer_tpu_torch.ops import gather as tgather
from clraytracer_tpu_torch.ops import gather_rows as gr

# tests/test_gather.py's shapes: (rows, width, index shape)
FORWARD_CASES = ((700, 25, (24, 128)), (512, 32, (9,)), (1500, 7, (4, 40)))


def _case(seed, t_rows, w, shape, lo=-3, hi=5, scale=100.0):
    rng = np.random.default_rng(seed)
    table = (rng.normal(size=(t_rows, w)) * scale).astype(np.float32)
    idx = rng.integers(lo, t_rows + hi, shape).astype(np.int32)
    idx.flat[0], idx.flat[-1] = lo, t_rows + hi - 1  # both clip sides
    return table, idx


def _port_take(table, idx):
    """The port's wide-row gather on numpy inputs → numpy [W, *shape]."""
    return tgather.wide_rows_diff(torch.from_numpy(table), torch.from_numpy(idx)).numpy()


@pytest.mark.parametrize("t_rows,w,shape", FORWARD_CASES)
def test_gather_matches_take_rows_and_mxu_kernel(t_rows, w, shape):
    """Bit-exact against the XLA row gather and the Pallas MXU kernel
    (interpret mode), clip-mode out-of-range indices included."""
    table, idx = _case(1, t_rows, w, shape)
    assert (idx < 0).any() and (idx >= t_rows).any()
    got = _port_take(table, idx)
    ref = np.asarray(jgather.take_rows(jnp.asarray(table), jnp.asarray(idx)))
    mxu = np.asarray(take_rows_mxu(jnp.asarray(table), jnp.asarray(idx)))
    assert got.shape == (w,) + shape
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, mxu)
    flat = gr.gather_rows_plain(torch.from_numpy(table), torch.from_numpy(idx.ravel()))
    np.testing.assert_array_equal(flat.numpy(), ref.reshape(w, -1))


def _port_vjp(table, idx, g):
    t = torch.from_numpy(table).requires_grad_(True)
    out = tgather.wide_rows_diff(t, torch.from_numpy(idx))
    out.backward(torch.from_numpy(g))
    return t.grad.numpy()


def test_vjp_matches_mxu_kernel_and_scatter():
    """The backward against the MXU kernel's VJP (interpret mode) and XLA's
    scatter-add, on tests/test_gather.py's coherent sorted indices, at
    rtol/atol 1e-5 (sums in another order)."""
    rng = np.random.default_rng(2)
    t_rows, w = 1300, 25
    table = rng.normal(size=(t_rows, w)).astype(np.float32)
    idx = np.sort(rng.integers(0, t_rows, (16, 128)).astype(np.int32), axis=None)
    idx = idx.reshape(16, 128)
    g = rng.normal(size=(w, 16, 128)).astype(np.float32)
    got = _port_vjp(table, idx, g)
    tj, ij, gj = jnp.asarray(table), jnp.asarray(idx), jnp.asarray(g)
    (ref,) = jax.vjp(lambda t: jgather.take_rows(t, ij), tj)[1](gj)
    (mxu,) = jax.vjp(lambda t: take_rows_mxu(t, ij), tj)[1](gj)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(mxu), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("t_rows,w,shape", FORWARD_CASES)
def test_scatter_plain_matches_take_rows_vjp(t_rows, w, shape):
    """``scatter_rows_plain`` against the VJP of ``take_rows`` with clip-mode
    out-of-range indices (they add into the first and last rows)."""
    table, idx = _case(3, t_rows, w, shape, scale=1.0)
    g = np.random.default_rng(4).normal(size=(w,) + shape).astype(np.float32)
    got = gr.scatter_rows_plain(
        torch.from_numpy(g.reshape(w, -1)), torch.from_numpy(idx.ravel()), t_rows
    ).numpy()
    ij = jnp.asarray(idx)
    (ref,) = jax.vjp(lambda t: jgather.take_rows(t, ij), jnp.asarray(table))[1](
        jnp.asarray(g)
    )
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_port_vjp(table, idx, g), got, rtol=1e-6, atol=1e-6)


def test_take_rows_gradcheck_f64():
    """TakeRows (plain path) through torch.autograd.gradcheck in f64, with
    repeated and out-of-range indices."""
    rng = np.random.default_rng(5)
    table = torch.tensor(rng.normal(size=(13, 5)), dtype=torch.float64,
                         requires_grad=True)
    idx = torch.tensor(rng.integers(-2, 16, 40), dtype=torch.int32)
    assert torch.autograd.gradcheck(lambda t: gr.TakeRows.apply(t, idx), (table,))


def test_scatter_plain_zero_terms_leave_plus_zero():
    """The rows nothing lands on stay +0; rows that only receive exact zeros
    of either sign also read +0 (as the kernel's skip of zero terms gives)."""
    g = torch.tensor([[0.0, -0.0, 1.5, 0.0]])
    idx = torch.tensor([0, 0, 2, 3], dtype=torch.int32)
    d = gr.scatter_rows_plain(g, idx, 5)
    assert d[:, 0].tolist() == [0.0, 0.0, 1.5, 0.0, 0.0]
    assert not torch.signbit(d).any()


def test_cpu_gathers_launch_no_kernel():
    before = (gr.gather_rows_cuda.launches, gr.scatter_rows_cuda.launches)
    table, idx = _case(6, 64, 25, (300,))
    g = np.ones((25, 300), np.float32)
    _port_vjp(table, idx, g)
    assert (gr.gather_rows_cuda.launches, gr.scatter_rows_cuda.launches) == before


def test_small_gathers_match_take_rows():
    """``small_rows_diff``/``take_rgb`` values against the JAX gathers
    (select chain and one-hot forms for small tables) on clip-mode indices."""
    table, idx = _case(7, 6, 17, (5, 9), scale=1.0)
    got = tgather.small_rows_diff(torch.from_numpy(table), torch.from_numpy(idx))
    ref = jgather.small_rows_diff(jnp.asarray(table), jnp.asarray(idx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    pool, pidx = _case(8, 50, 4, (7, 3), scale=1.0)
    got = tgather.take_rgb(torch.from_numpy(pool), torch.from_numpy(pidx))
    ref = jgather.take_rgb(jnp.asarray(pool), jnp.asarray(pidx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
