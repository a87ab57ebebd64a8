"""A scene built to give equal-t hits, its rays, and the lexicographic
nearest hit by brute force: shared by the CPU tests (tests/test_torch_trace.py)
and the card tests (tests/test_torch_cuda.py). Imports no JAX."""

import dataclasses
import importlib
import types

import numpy as np
import torch

from clraytracer_tpu_torch.ops import trace as tr
from clraytracer_tpu_torch.ops.clusters import CLUSTER_SIZE

MESH_FIELDS = ("v0", "v1", "v2", "uv0", "uv1", "uv2", "n0", "n1", "n2", "mat_idx")


def package(name: str) -> types.SimpleNamespace:
    """The scene-building parts of ``clraytracer_tpu`` or its port."""
    mod = lambda sub: importlib.import_module(f"{name}.{sub}")
    return types.SimpleNamespace(
        SceneBuilder=mod("scene").SceneBuilder,
        ptex=mod("scene.procedural_tex"),
        uv_sphere=mod("scene.procedural").uv_sphere,
        cube=mod("scene.procedural").cube,
        quad=mod("scene.procedural").quad,
        math3d=mod("math3d"),
    )


def tie_recipe(pkg):
    """Equal-t hits by construction: instances 0 and 2 are one cube under
    one transform (every hit on them ties across instances), and instance 1
    is a quad whose first triangle appears twice (hits on it tie across
    slots of one instance)."""
    b = pkg.SceneBuilder()
    b.import_procedural(pkg.ptex.sky_gradient(64, 32))
    mat = b.create_material(albedo=(0.6, 0.5, 0.4))
    cube = b.add_mesh(pkg.cube(1.0), materials_start=mat)
    q = pkg.quad(3.0, y=-1.5)
    dup = dataclasses.replace(
        q, **{f: np.concatenate([getattr(q, f), getattr(q, f)[:1]]) for f in MESH_FIELDS}
    )
    floor = b.add_mesh(dup, materials_start=mat)
    at = pkg.math3d.rotation_y(0.4) @ pkg.math3d.translation(0.3, 0.2, 0.0)
    b.add_instance(cube, at)
    b.add_instance(floor)
    b.add_instance(cube, at)
    return b


def tie_rays(n: int = 2048, seed: int = 0) -> np.ndarray:
    """[6, n] f32 rays from a shell of radius 7 above the scene towards
    seeded points in the box the cube and the quad span."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(3, n))
    o[1] = np.abs(o[1])
    o = o / np.linalg.norm(o, axis=0) * 7.0
    target = rng.uniform([-2.5, -1.5, -2.5], [2.5, 1.4, 2.5], size=(n, 3)).T
    d = target - o
    d = d / np.linalg.norm(d, axis=0)
    return np.concatenate([o, d]).astype(np.float32)


def lex_nearest(kt: tr.KernelTables, rays: torch.Tensor):
    """Per ray, the accepted candidate of least (t, instance, slot) over
    every slot of every instance, with the kernel's plane test: (t [n],
    instance [n], slot [n], candidates at that t [n]); t = inf on a miss."""
    o, d = rays[0:3, :, None], rays[3:6, :, None]
    ts, insts, slots = [], [], []
    for inst, (_sc0, _scn, cl0, cl_n) in enumerate(kt.ranges_host):
        ox, oy, oz, dx, dy, dz = tr._object_ray(kt.inst[inst], o, d)
        s0, s1 = cl0 * CLUSTER_SIZE, (cl0 + cl_n) * CLUSTER_SIZE
        nx, ny, nz, nw, ux, uy, uz, uw, vx, vy, vz, vw = kt.planes[s0:s1].T[:, None, :]
        den = dx * nx + dy * ny + dz * nz
        t = (ox * nx + oy * ny + oz * nz + nw) * (-1.0 / den)
        u = (ox * ux + oy * uy + oz * uz + uw) + t * (dx * ux + dy * uy + dz * uz)
        v = (ox * vx + oy * vy + oz * vz + vw) + t * (dx * vx + dy * vy + dz * vz)
        ok = (t > 0.0) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t < tr.BIG)
        ts.append(torch.where(ok, t, torch.full_like(t, float("inf"))))
        insts.append(torch.full((s1 - s0,), inst))
        slots.append(torch.arange(s0, s1))
    t_all = torch.cat(ts, dim=1)  # columns in (instance, slot) order
    best = t_all.min(dim=1).values
    at_best = (t_all == best[:, None]) & torch.isfinite(best)[:, None]
    first = at_best.int().argmax(dim=1)  # the first column: least (inst, slot)
    return (
        best, torch.cat(insts).to(rays.device)[first],
        torch.cat(slots).to(rays.device)[first], at_best.sum(dim=1),
    )
