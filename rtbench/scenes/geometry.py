# Frozen copy of clraytracer_tpu_torch/scene/procedural.py (MeshData, uv_sphere, sphere_field) and chip_smoke.py (_soup, _quad_grid, museum_meshes, museum_texture) at commit c1cdb28.
"""The benchmark's own mesh and texture generators.

Copied from the program and frozen here, so that a later change to the
program's generators cannot change the benchmark's inputs. ``Mesh`` is a
triangle soup of f32 numpy arrays; ``mat`` is local to the mesh's material
block.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Mesh:
    """Host-side triangle soup (numpy)."""

    v0: np.ndarray  # [T, 3] f32
    v1: np.ndarray
    v2: np.ndarray
    uv0: np.ndarray  # [T, 2] f32
    uv1: np.ndarray
    uv2: np.ndarray
    n0: np.ndarray  # [T, 3] f32
    n1: np.ndarray
    n2: np.ndarray
    mat: np.ndarray  # [T] i32

    @property
    def count(self) -> int:
        return self.v0.shape[0]

    def concat(self, other: "Mesh") -> "Mesh":
        return Mesh(**{
            f.name: np.concatenate([getattr(self, f.name), getattr(other, f.name)])
            for f in dataclasses.fields(self)
        })

    def take(self, idx: np.ndarray) -> "Mesh":
        return Mesh(**{f.name: getattr(self, f.name)[idx] for f in dataclasses.fields(self)})

    def translated(self, offset) -> "Mesh":
        off = np.asarray(offset, np.float32)
        return dataclasses.replace(self, v0=self.v0 + off, v1=self.v1 + off, v2=self.v2 + off)


def _from_indexed(pos, uv, nrm, faces, mat) -> Mesh:
    """faces: [T, 3] vertex indices shared by position, uv and normal."""
    f = faces
    return Mesh(
        v0=pos[f[:, 0]].astype(np.float32), v1=pos[f[:, 1]].astype(np.float32),
        v2=pos[f[:, 2]].astype(np.float32),
        uv0=uv[f[:, 0]].astype(np.float32), uv1=uv[f[:, 1]].astype(np.float32),
        uv2=uv[f[:, 2]].astype(np.float32),
        n0=nrm[f[:, 0]].astype(np.float32), n1=nrm[f[:, 1]].astype(np.float32),
        n2=nrm[f[:, 2]].astype(np.float32),
        mat=np.full(f.shape[0], mat, np.int32),
    )


def uv_sphere(radius: float = 1.0, n_lat: int = 16, n_lon: int = 32, material: int = 0) -> Mesh:
    """UV sphere centred at the origin: 2 * n_lon * (n_lat - 1) triangles."""
    lat = np.linspace(0.0, np.pi, n_lat + 1)
    lon = np.linspace(0.0, 2.0 * np.pi, n_lon + 1)
    th, ph = np.meshgrid(lat, lon, indexing="ij")
    x = np.sin(th) * np.cos(ph)
    y = np.cos(th)
    z = np.sin(th) * np.sin(ph)
    pos = np.stack([x, y, z], axis=-1).reshape(-1, 3).astype(np.float32)
    normals = pos.copy()
    uv = np.stack([ph / (2 * np.pi), th / np.pi], axis=-1).reshape(-1, 2).astype(np.float32)
    pos = pos * radius

    def vid(i, j):
        return i * (n_lon + 1) + j

    faces = []
    for i in range(n_lat):
        j = np.arange(n_lon)
        a, b, c, d = vid(i, j), vid(i + 1, j), vid(i + 1, j + 1), vid(i, j + 1)
        if i > 0:  # upper triangles (skip the degenerate ones at the pole)
            faces.append(np.stack([a, b, d], axis=1))
        if i < n_lat - 1:
            faces.append(np.stack([b, c, d], axis=1))
    return _from_indexed(pos, uv, normals, np.concatenate(faces, axis=0), material)


def sphere_field(n_side: int = 10, spacing: float = 3.0, n_lat: int = 24, n_lon: int = 48) -> Mesh:
    """An n_side x n_side grid of unit spheres, centres at y = 1."""
    base = uv_sphere(1.0, n_lat, n_lon)
    offset0 = -(n_side - 1) * spacing / 2
    out = None
    for i in range(n_side):
        for j in range(n_side):
            m = base.translated((offset0 + i * spacing, 1.0, offset0 + j * spacing))
            out = m if out is None else out.concat(m)
    return out


def _quad_grid(n: int, corner, du, dv, normal, uv_scale: float) -> Mesh:
    """An n x n grid of quads spanning corner + [0,1]^2 of (du, dv), uvs
    tiling ``uv_scale`` times, each quad split into (0, 1, 2), (0, 2, 3)."""
    i, j = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    i, j = i.reshape(-1, 1), j.reshape(-1, 1)
    a = np.array([[0, 0], [1, 0], [1, 1], [0, 1]])
    s = (i + a[None, :, 0]) / n
    t = (j + a[None, :, 1]) / n
    c, du, dv = (np.asarray(x, np.float32) for x in (corner, du, dv))
    pos = (c + s[..., None] * du + t[..., None] * dv).astype(np.float32)  # [F, 4, 3]
    uv = (np.stack([s, t], axis=-1) * uv_scale).astype(np.float32)
    nrm = np.broadcast_to(np.asarray(normal, np.float32), pos.shape)
    tri = lambda x, k: np.concatenate([x[:, 0], x[:, 0]]) if k == 0 else (
        np.concatenate([x[:, 1], x[:, 2]]) if k == 1 else np.concatenate([x[:, 2], x[:, 3]]))
    return Mesh(
        v0=tri(pos, 0), v1=tri(pos, 1), v2=tri(pos, 2),
        uv0=tri(uv, 0), uv1=tri(uv, 1), uv2=tri(uv, 2),
        n0=tri(nrm, 0).copy(), n1=tri(nrm, 1).copy(), n2=tri(nrm, 2).copy(),
        mat=np.zeros(2 * pos.shape[0], np.int32),
    )


def _grouped(groups: list[Mesh]) -> Mesh:
    """One mesh of the groups, group k's triangles on local material k."""
    out = None
    for k, g in enumerate(groups):
        g = dataclasses.replace(g, mat=np.full(g.count, k, np.int32))
        out = g if out is None else out.concat(g)
    return out


def museum_meshes() -> dict[str, Mesh]:
    """The museum-class scene's three meshes, one local material per group.
    atrium (the sponza role): a hall of 64 spheres on a quad-grid floor with
    back and side walls, 20 materials; gallery (sibenik): 36 larger spheres,
    14 materials; figure (nanosuit): one dense sphere in 8 latitude bands.
    161,360 triangles."""
    field = sphere_field(n_side=8, spacing=3.0, n_lat=16, n_lon=32)
    per = field.count // 64
    groups = []
    for m in range(18):  # spheres k with k % 18 == m share material m
        groups.append(field.take(np.concatenate(
            [np.arange(k * per, (k + 1) * per) for k in range(64) if k % 18 == m])))
    groups.append(_quad_grid(40, (-30, 0, -30), (60, 0, 0), (0, 0, 60), (0, 1, 0), 12.0))
    walls = [_quad_grid(20, (-30, 0, -20), (60, 0, 0), (0, 30, 0), (0, 0, 1), 6.0),
             _quad_grid(20, (-30, 0, 30), (0, 0, -60), (0, 30, 0), (1, 0, 0), 6.0),
             _quad_grid(20, (30, 0, -30), (0, 0, 60), (0, 30, 0), (-1, 0, 0), 6.0)]
    groups.append(walls[0].concat(walls[1]).concat(walls[2]))
    out = {"atrium": _grouped(groups)}

    field = sphere_field(n_side=6, spacing=5.0, n_lat=20, n_lon=40)
    per = field.count // 36
    out["gallery"] = _grouped([
        field.take(np.concatenate([np.arange(k * per, (k + 1) * per)
                                   for k in range(36) if k % 14 == m]))
        for m in range(14)])
    fig = uv_sphere(1.5, 100, 200)
    band = np.minimum(
        ((fig.v0[:, 1] + fig.v1[:, 1] + fig.v2[:, 1]) / 3.0 + 1.5) / 3.0 * 8, 7).astype(int)
    out["figure"] = _grouped([fig.take(np.nonzero(band == m)[0]) for m in range(8)])
    return out


def museum_texture(seed, size: int) -> np.ndarray:
    """A [size, size, 3] u8 map: a seeded checker of two colours over a
    diagonal ramp, with noise (at most 199 + 47 + 7, so no clipping)."""
    rng = np.random.default_rng(seed)
    i = np.arange(size)
    cells = int(rng.integers(4, 17))
    c0, c1 = rng.integers(0, 200, (2, 3), dtype=np.uint8)
    cell = i * cells // size
    chk = (cell[:, None] + cell[None, :]) % 2 == 1
    ramp = ((i[:, None] + i[None, :]) * 48 // (2 * size)).astype(np.uint8)
    img = np.where(chk[..., None], c0, c1) + ramp[..., None]
    return img + rng.integers(0, 8, (size, size, 3), dtype=np.uint8)
