"""The port's ``trace`` (plain version on the CPU) against the JAX
``trace_pallas`` (Pallas interpret mode, as tests/test_trace.py runs it)
and the golden ``trace_brute``, on the same scene carried across by the
bridge and the same rays."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from clraytracer_tpu.camera import Camera, ray_directions_planar
from clraytracer_tpu.config import CameraConfig
from clraytracer_tpu.ops.trace_pallas import trace_pallas
from clraytracer_tpu.ops.trace_ref import trace_brute
from clraytracer_tpu_torch.ops import trace as ttrace
from clraytracer_tpu_torch.scene.bridge import scene_from_numpy
from test_torch_scene import flatten

# (fixture, camera position): the positions tests/test_trace.py uses
SCENES = {
    "sphere_scene": (0.13, 0.21, 10.0),
    "two_instance_scene": (0.07, 1.11, 8.0),
}


def assert_hits_match(hb, hv, max_mismatch_frac=0.01):
    """Golden-hit comparison tolerating seam ties (the rule of
    tests/test_trace.py::assert_hits_match, copied): rays on a shared
    triangle edge may resolve to either neighbour."""
    hit_b = np.asarray(hb.hit)
    hit_v = np.asarray(hv.hit)
    n = hit_b.size
    hit_mismatch = (hit_b != hit_v).sum()
    assert hit_mismatch <= max(1, max_mismatch_frac * n), hit_mismatch
    both = hit_b & hit_v
    tb, tv = np.asarray(hb.t)[both], np.asarray(hv.t)[both]
    close = np.isclose(tb, tv, rtol=1e-4, atol=1e-5)
    assert close.mean() > 0.99, f"{(~close).sum()} of {close.size} t values differ"
    trib, triv = np.asarray(hb.tri)[both], np.asarray(hv.tri)[both]
    assert (trib == triv).mean() > 0.98


def _rays(position, w=32, h=24):
    cam = Camera.create(CameraConfig(position=position), w, h)
    d = ray_directions_planar(
        jnp.asarray(cam.inverse_view), jnp.asarray(cam.inverse_projection), w, h
    )
    o = jnp.broadcast_to(jnp.asarray(cam.position)[:, None, None], d.shape)
    return np.array(o), np.array(d)


@pytest.fixture(scope="module")
def port_scenes(request):
    return {
        name: scene_from_numpy(*flatten(request.getfixturevalue(name)), device="cpu")
        for name in SCENES
    }


@pytest.mark.parametrize("return_slots", [False, True])
@pytest.mark.parametrize("with_live", [False, True])
@pytest.mark.parametrize("name", list(SCENES))
def test_trace_matches_pallas(name, with_live, return_slots, request, port_scenes):
    jscene = request.getfixturevalue(name)
    o, d = _rays(SCENES[name])
    live = None
    if with_live:
        live = np.random.default_rng(0).uniform(size=o.shape[1:]) > 0.3
    hp = trace_pallas(
        jscene, jnp.asarray(o), jnp.asarray(d),
        live=None if live is None else jnp.asarray(live),
        return_slots=return_slots,
    )
    ht = ttrace.trace(
        port_scenes[name], torch.from_numpy(o), torch.from_numpy(d),
        live=None if live is None else torch.from_numpy(live),
        return_slots=return_slots,
    )
    assert np.asarray(hp.hit).sum() > 20
    assert_hits_match(hp, ht)
    if live is not None:
        assert not np.asarray(ht.hit)[~live].any()
    # attributes wherever both pick the same triangle. u and v are sums of
    # O(10)-sized terms (the camera is 8-10 units out), and XLA on the CPU
    # may contract them into FMAs where torch does not: one ulp of those
    # terms is ~1e-6 absolute, hence atol 1e-5 (the material id is exact)
    same = np.asarray(hp.hit) & ht.hit.numpy() & (np.asarray(hp.tri) == ht.tri.numpy())
    for a, b in (
        (hp.attr_normal, ht.attr_normal), (hp.attr_uu, ht.attr_uu),
        (hp.attr_vv, ht.attr_vv), (hp.u, ht.u), (hp.v, ht.v),
    ):
        a, b = np.asarray(a), b.numpy()
        a, b = (a[:, same], b[:, same]) if a.ndim == 3 else (a[same], b[same])
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(
        ht.attr_mat.numpy()[same], np.asarray(hp.attr_mat)[same]
    )
    np.testing.assert_array_equal(
        ht.instance.numpy()[same], np.asarray(hp.instance)[same]
    )


@pytest.mark.parametrize("name", list(SCENES))
def test_trace_matches_brute(name, request, port_scenes):
    o, d = _rays(SCENES[name])
    hb = trace_brute(request.getfixturevalue(name), jnp.asarray(o), jnp.asarray(d))
    ht = ttrace.trace(port_scenes[name], torch.from_numpy(o), torch.from_numpy(d))
    assert np.asarray(hb.hit).sum() > 20
    assert_hits_match(hb, ht)


def test_trace_plain_has_no_launches(port_scenes):
    before = ttrace.trace_cuda.launches
    o, d = _rays(SCENES["sphere_scene"], 8, 6)
    ttrace.trace(port_scenes["sphere_scene"], torch.from_numpy(o), torch.from_numpy(d))
    assert ttrace.trace_cuda.launches == before



# ~70k triangles: 69 superclusters in three hyper groups, the only CPU
# scene whose traversal crosses hyper groups (32 supers each)
MULTI_HYPER_TRIS = 70000


@pytest.fixture(scope="module")
def multi_hyper():
    from clraytracer_tpu.cli import build_scene as jax_build
    from clraytracer_tpu_torch.cli import build_scene as port_build

    return (
        jax_build("sphere", MULTI_HYPER_TRIS),
        port_build("sphere", MULTI_HYPER_TRIS, device="cpu"),
    )


def test_kernel_tables_hierarchy_multi_hyper(multi_hyper):
    """The index walk of csrc/traverse.cuh on a scene with several hyper
    groups: hyper ``sc0 // 32 + sl // 32`` holds super ``sc0 + sl``, which
    holds clusters ``cl0 + 32 * sl ... cl0 + min(cl_n, 32 * sl + 32)``;
    every cluster of the instance is visited exactly once and every box
    lies inside its parent's. Supers past ``sc_n`` are padding."""
    kt = ttrace.kernel_tables(multi_hyper[1])
    hyper, sup, clus = (
        b.numpy() for b in (kt.hyper_box, kt.super_box, kt.cluster_box)
    )

    def inside(child, parent):
        return (child[:3] >= parent[:3]).all() and (child[3:6] <= parent[3:6]).all()

    for sc0, sc_n, cl0, cl_n in kt.ranges_host:
        assert sc0 % 32 == 0
        n_hyper = -(-sc_n // 32)
        assert n_hyper >= 3
        visited = []
        for hy in range(n_hyper):
            for sl in range(hy * 32, min(sc_n, (hy + 1) * 32)):
                assert inside(sup[sc0 + sl], hyper[sc0 // 32 + hy])
                for cl in range(sl * 32, min(cl_n, (sl + 1) * 32)):
                    assert inside(clus[cl0 + cl], sup[sc0 + sl])
                    visited.append(cl0 + cl)
        assert visited == list(range(cl0, cl0 + cl_n))


def test_trace_matches_brute_multi_hyper(multi_hyper):
    jscene, port = multi_hyper
    o, d = _rays(SCENES["sphere_scene"])
    hb = trace_brute(jscene, jnp.asarray(o), jnp.asarray(d))
    ht = ttrace.trace(port, torch.from_numpy(o), torch.from_numpy(d))
    assert np.asarray(hb.hit).sum() > 20
    assert_hits_match(hb, ht)


def test_tables_shared_by_scenes_sharing_clusters_and_packed(port_scenes):
    """A ``dataclasses.replace`` of the materials (one fit step) keeps the
    traversal and frame tables: they are kept with the scene's ``packed``
    object, for its ``clusters`` object and instance meshes, not with the
    Scene. A packed object made outside ``ops.trace`` (a bare
    ``dataclasses.replace``) gets tables of its own at its first use, and
    so does another ``clusters`` object or another instance-mesh list; an
    edit through ``ops.trace`` (``refresh_packed``) hands its new packed
    object the old geometry and descriptor tensors."""
    import dataclasses

    from clraytracer_tpu_torch.ops.shade import refresh_packed

    scene = port_scenes["two_instance_scene"]
    mats = dataclasses.replace(
        scene.materials, albedo=scene.materials.albedo.clone()
    )
    other = dataclasses.replace(scene, materials=mats)
    kt, ft = ttrace.kernel_tables(scene), ttrace.frame_tables(scene)
    assert ttrace.kernel_tables(other) is kt
    assert ttrace.frame_tables(other) is ft
    rebuilt = dataclasses.replace(
        scene, packed=dataclasses.replace(scene.packed)
    )
    assert ttrace.kernel_tables(rebuilt) is not kt
    assert ttrace.kernel_tables(rebuilt).planes is not kt.planes
    assert ttrace.frame_tables(rebuilt) is not ft
    edited = refresh_packed(other)
    ke, fe = ttrace.kernel_tables(edited), ttrace.frame_tables(edited)
    assert ke is not kt and fe is not ft
    assert ke.planes is kt.planes and ke.ranges is kt.ranges and fe.tex is ft.tex
    moved = dataclasses.replace(scene, clusters=dataclasses.replace(scene.clusters))
    assert ttrace.kernel_tables(moved) is not kt
    assert len(set(scene.clusters.mesh_ranges)) > 1
    first = (scene.instances.mesh_index[0],) * scene.instances.count
    meshes = dataclasses.replace(scene, instances=dataclasses.replace(
        scene.instances, mesh_index=first))
    assert first != scene.instances.mesh_index
    assert ttrace.kernel_tables(meshes).ranges_host == (kt.ranges_host[0],) * len(first)


@pytest.fixture(scope="module")
def tie_scenes():
    from _torch_ties import package, tie_recipe

    return (
        tie_recipe(package("clraytracer_tpu")).build(),
        tie_recipe(package("clraytracer_tpu_torch")).build(device="cpu"),
    )


def test_trace_plain_tie_rule(tie_scenes):
    """Equal-t hits resolve to the least (instance, slot): two instances
    of one cube under one transform tie on every cube hit, a duplicated
    floor triangle ties across two slots. This is the rule K2.1 keeps on
    the card whatever order its warps visit the clusters in."""
    from _torch_ties import lex_nearest, tie_rays

    jscene, port = tie_scenes
    kt = ttrace.kernel_tables(port)
    rays = torch.from_numpy(tie_rays())
    out = ttrace.trace_plain(kt, rays)
    t_ref, inst_ref, slot_ref, at_best = lex_nearest(kt, rays)
    hit = torch.isfinite(t_ref)
    assert torch.equal(out[0].abs() < ttrace.BIG, hit)
    assert torch.equal(out[0][hit], t_ref[hit])
    assert torch.equal(out[4].view(torch.int32)[hit].long(), inst_ref[hit])
    assert torch.equal(out[3].view(torch.int32)[hit].long(), slot_ref[hit])
    tied = at_best > 1
    assert int((tied & (inst_ref == 0)).sum()) > 100  # cube: instance 0 over 2
    assert int((tied & (inst_ref == 1)).sum()) > 100  # floor: the lower slot

    # t and hit against the JAX package's golden brute force
    o, d = rays[0:3].numpy(), rays[3:6].numpy()
    hb = trace_brute(jscene, jnp.asarray(o), jnp.asarray(d))
    hit_b = np.asarray(hb.hit)
    np.testing.assert_array_equal(hit.numpy(), hit_b)
    np.testing.assert_allclose(
        out[0].numpy()[hit_b], np.asarray(hb.t)[hit_b], rtol=1e-5, atol=1e-6
    )
    np.testing.assert_array_equal(
        out[4].view(torch.int32).numpy()[hit_b], np.asarray(hb.instance)[hit_b]
    )


def test_counter_names_match_kernel_header():
    """``ops.trace.COUNTER_NAMES`` is the kernels' TestCount, field for
    field (csrc/traverse.cuh), so a counters tensor is never too short."""
    import re
    from pathlib import Path

    src = (Path(ttrace.__file__).parents[1] / "csrc" / "traverse.cuh").read_text()
    n = int(re.search(r"#define CLRT_COUNTERS (\d+)", src).group(1))
    fields = re.search(r"struct TestCount \{\s*unsigned (?:int|long long) ([^;]+);", src).group(1)
    assert n == len(ttrace.COUNTER_NAMES) == len(fields.split(","))


@pytest.mark.parametrize(
    "shape,dtype", [((4,), torch.int64), ((6,), torch.int32), ((2, 3), torch.int64)]
)
def test_counters_of_another_shape_refused(shape, dtype):
    with pytest.raises(ValueError):
        ttrace.check_counters(torch.zeros(shape, dtype=dtype), torch.device("cpu"))
    ttrace.check_counters(None, torch.device("cpu"))
    ttrace.check_counters(torch.zeros(6, dtype=torch.int64), torch.device("cpu"))


def test_kernel_tables_are_16_byte_aligned(multi_hyper):
    """The kernels read box and plane rows as float4 (and copy planes with
    16-byte cp.async): ``kernel_tables`` hands them aligned tables."""
    kt = ttrace.kernel_tables(multi_hyper[1])
    for t in (kt.hyper_box, kt.super_box, kt.cluster_box, kt.planes):
        assert t.is_contiguous() and t.data_ptr() % 16 == 0
    assert ttrace._aligned(torch.zeros(9)[1:].reshape(-1, 8)).data_ptr() % 16 == 0
