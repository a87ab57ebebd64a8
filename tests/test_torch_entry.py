"""The port's entry points (clraytracer_tpu_torch.entry) against the JAX
package's ``__graft_entry__.py``, on the CPU: the flagship scene leaf for
leaf, ``entry()``'s frame against the JAX ``entry()`` jitted on the CPU
(its fused kernel in interpret mode) by the frame rule (at least 99% of
pixels within 1e-5), and ``dryrun_multichip`` over 2 and 4 gloo ranks,
processes started by the function itself, each world with its launcher's
timeout: its loss equal to one rank's ``train_step_sharded`` on the same
frame within rtol 1e-4."""

import numpy as np
import pytest
import torch

import jax

import __graft_entry__ as jentry
from clraytracer_tpu_torch import entry as tentry
from clraytracer_tpu_torch.parallel.sharding import make_device_mesh, train_step_sharded
from clraytracer_tpu_torch.scene.bridge import scene_from_numpy
from _torch_threads import one_torch_thread  # noqa: F401
from test_torch_scene import assert_leaves_equal, flatten, port_leaves


@pytest.fixture(scope="module")
def jax_entry_frame():
    """The JAX ``entry()``'s frame, jitted once for the module (about 40 s:
    the Pallas kernel compiles in interpret mode)."""
    fn, args = jentry.entry()
    return np.asarray(jax.jit(fn)(*args))


@pytest.mark.parametrize("n_lat,n_lon", [(16, 32), (6, 8)])
def test_flagship_scene_leaf_for_leaf(n_lat, n_lon):
    """The port's recipe builds the JAX recipe's scene: every leaf equal to
    the JAX scene's, as the bridge carries it across."""
    jscene = jentry._flagship_scene(n_lat=n_lat, n_lon=n_lon)
    port = tentry._flagship_scene(n_lat=n_lat, n_lon=n_lon, device="cpu")
    assert_leaves_equal(*flatten(jscene), port)
    bridged = port_leaves(scene_from_numpy(*flatten(jscene), device="cpu"))
    mine = port_leaves(port)
    assert mine[0].keys() == bridged[0].keys()
    for key, arr in bridged[0].items():
        np.testing.assert_array_equal(mine[0][key], arr, err_msg=key)


def test_entry_frame_matches_jax(jax_entry_frame):
    fn, (scene, frame) = tentry.entry(device="cpu")
    assert scene.device.type == "cpu"
    got = fn(scene, frame).numpy()
    assert got.shape == jax_entry_frame.shape == (192, 256, 3)
    assert np.isfinite(got).all()
    close = np.isclose(got, jax_entry_frame, rtol=0.0, atol=1e-5).all(axis=-1)
    assert close.mean() >= 0.99, close.mean()


def _one_rank_loss(n: int) -> float:
    """The dry run's step on a world of one (no process group)."""
    w, h = tentry.DRYRUN_WIDTH, tentry.DRYRUN_ROWS * n
    dev = torch.device("cpu")
    target = np.random.default_rng(0).uniform(0, 1, (h, w, 3)).astype(np.float32)
    loss, _ = train_step_sharded(tentry._flagship_scene(6, 8, device=dev),
                                 tentry._frame(w, h, dev), torch.from_numpy(target),
                                 make_device_mesh(device=dev), lr=1e-2)
    return float(loss)


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip_matches_one_rank(n, capsys):
    loss = tentry.dryrun_multichip(n, device="cpu")
    assert capsys.readouterr().out.strip() == f"dryrun_multichip({n}): ok, loss={loss:.5f}"
    assert np.isfinite(loss)
    np.testing.assert_allclose(loss, _one_rank_loss(n), rtol=1e-4)


def test_dryrun_multichip_refuses_an_empty_world():
    with pytest.raises(ValueError):
        tentry.dryrun_multichip(0, device="cpu")
