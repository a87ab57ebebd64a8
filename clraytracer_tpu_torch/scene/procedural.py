"""Procedural test geometry (numpy; the same generators as the JAX package).

The reference ships binary scene assets (Assets/*.obj via .clm caches); for
hermetic tests and benchmarks we generate equivalent meshes: UV spheres (the
bundled ``sphere.obj`` scene of BASELINE config 1), cubes, and quads, each with
proper uv/normal attributes, plus helpers to tile many instances for large
scenes (config 5).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class MeshData:
    """Host-side triangle soup for one mesh (numpy)."""

    v0: np.ndarray  # [T, 3] f32
    v1: np.ndarray
    v2: np.ndarray
    uv0: np.ndarray  # [T, 2] f32
    uv1: np.ndarray
    uv2: np.ndarray
    n0: np.ndarray  # [T, 3] f32
    n1: np.ndarray
    n2: np.ndarray
    mat_idx: np.ndarray  # [T] i32, local to the mesh's material block

    @property
    def count(self) -> int:
        return self.v0.shape[0]

    @staticmethod
    def from_indexed(
        positions: np.ndarray,
        uvs: np.ndarray,
        normals: np.ndarray,
        faces: np.ndarray,
        mat_idx: np.ndarray | None = None,
    ) -> "MeshData":
        """faces: [T, 3, 3] int indices (corner, [pos_idx, uv_idx, n_idx])."""
        f = faces
        if mat_idx is None:
            mat_idx = np.zeros(f.shape[0], np.int32)
        return MeshData(
            v0=positions[f[:, 0, 0]].astype(np.float32),
            v1=positions[f[:, 1, 0]].astype(np.float32),
            v2=positions[f[:, 2, 0]].astype(np.float32),
            uv0=uvs[f[:, 0, 1]].astype(np.float32),
            uv1=uvs[f[:, 1, 1]].astype(np.float32),
            uv2=uvs[f[:, 2, 1]].astype(np.float32),
            n0=normals[f[:, 0, 2]].astype(np.float32),
            n1=normals[f[:, 1, 2]].astype(np.float32),
            n2=normals[f[:, 2, 2]].astype(np.float32),
            mat_idx=mat_idx.astype(np.int32),
        )

    def concat(self, other: "MeshData") -> "MeshData":
        return MeshData(
            **{
                f.name: np.concatenate(
                    [getattr(self, f.name), getattr(other, f.name)], axis=0
                )
                for f in dataclasses.fields(self)
            }
        )

    def transformed(self, matrix: np.ndarray) -> "MeshData":
        """Bake a row-vector-convention transform into the vertices/normals."""
        rot = matrix[:3, :3]
        # normals by inverse-transpose of the linear part
        nrot = np.linalg.inv(rot).T

        def tp(v: np.ndarray) -> np.ndarray:
            return (v @ rot + matrix[3, :3]).astype(np.float32)

        def tn(n: np.ndarray) -> np.ndarray:
            out = n @ nrot
            return (out / np.linalg.norm(out, axis=-1, keepdims=True)).astype(
                np.float32
            )

        return dataclasses.replace(
            self,
            v0=tp(self.v0),
            v1=tp(self.v1),
            v2=tp(self.v2),
            n0=tn(self.n0),
            n1=tn(self.n1),
            n2=tn(self.n2),
        )


def uv_sphere(
    radius: float = 1.0, n_lat: int = 16, n_lon: int = 32, material: int = 0
) -> MeshData:
    """UV sphere centred at origin: 2 * n_lon * (n_lat - 1) triangles."""
    lat = np.linspace(0.0, np.pi, n_lat + 1)
    lon = np.linspace(0.0, 2.0 * np.pi, n_lon + 1)
    th, ph = np.meshgrid(lat, lon, indexing="ij")  # [n_lat+1, n_lon+1]
    x = np.sin(th) * np.cos(ph)
    y = np.cos(th)
    z = np.sin(th) * np.sin(ph)
    pos = np.stack([x, y, z], axis=-1).reshape(-1, 3).astype(np.float32)
    normals = pos.copy()
    uv = np.stack(
        [ph / (2 * np.pi), th / np.pi], axis=-1
    ).reshape(-1, 2).astype(np.float32)
    pos = pos * radius

    def vid(i: int | np.ndarray, j: int | np.ndarray) -> np.ndarray:
        return i * (n_lon + 1) + j

    faces = []
    for i in range(n_lat):
        j = np.arange(n_lon)
        a, b, c, d = vid(i, j), vid(i + 1, j), vid(i + 1, j + 1), vid(i, j + 1)
        if i > 0:  # upper triangles (skip degenerate at pole)
            faces.append(np.stack([a, b, d], axis=1))
        if i < n_lat - 1:
            faces.append(np.stack([b, c, d], axis=1))
    f = np.concatenate(faces, axis=0)
    f3 = np.stack([f, f, f], axis=-1)  # same index for pos/uv/normal
    mat = np.full(f.shape[0], material, np.int32)
    return MeshData.from_indexed(pos, uv, normals, f3, mat)


def cube(half: float = 1.0, material: int = 0) -> MeshData:
    """Axis-aligned cube, 12 triangles, per-face normals and uvs."""
    quads = []
    # (normal axis, sign)
    for axis in range(3):
        for sign in (1.0, -1.0):
            n = np.zeros(3, np.float32)
            n[axis] = sign
            u_ax, v_ax = [(a) for a in range(3) if a != axis]
            c00 = n * half
            verts = []
            for du, dv in ((-1, -1), (1, -1), (1, 1), (-1, 1)):
                p = c00.copy()
                p[u_ax] += du * half
                p[v_ax] += dv * half
                verts.append(p)
            if sign < 0:
                verts = verts[::-1]
            quads.append((np.stack(verts), n))
    v0, v1, v2, uv0, uv1, uv2, nrm = [], [], [], [], [], [], []
    quv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    for verts, n in quads:
        for tri in ((0, 1, 2), (0, 2, 3)):
            v0.append(verts[tri[0]])
            v1.append(verts[tri[1]])
            v2.append(verts[tri[2]])
            uv0.append(quv[tri[0]])
            uv1.append(quv[tri[1]])
            uv2.append(quv[tri[2]])
            nrm.append(n)
    t = len(v0)
    nrm = np.stack(nrm).astype(np.float32)
    return MeshData(
        v0=np.stack(v0).astype(np.float32),
        v1=np.stack(v1).astype(np.float32),
        v2=np.stack(v2).astype(np.float32),
        uv0=np.stack(uv0),
        uv1=np.stack(uv1),
        uv2=np.stack(uv2),
        n0=nrm.copy(),
        n1=nrm.copy(),
        n2=nrm.copy(),
        mat_idx=np.full(t, material, np.int32),
    )


def quad(
    size: float = 1.0, y: float = 0.0, material: int = 0, uv_scale: float = 1.0
) -> MeshData:
    """Horizontal quad (two triangles) in the XZ plane facing +Y."""
    s = size
    pos = np.array(
        [[-s, y, -s], [s, y, -s], [s, y, s], [-s, y, s]], np.float32
    )
    uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32) * uv_scale
    n = np.array([0, 1, 0], np.float32)
    tris = ((0, 2, 1), (0, 3, 2))
    return MeshData(
        v0=pos[[t[0] for t in tris]],
        v1=pos[[t[1] for t in tris]],
        v2=pos[[t[2] for t in tris]],
        uv0=uv[[t[0] for t in tris]],
        uv1=uv[[t[1] for t in tris]],
        uv2=uv[[t[2] for t in tris]],
        n0=np.tile(n, (2, 1)),
        n1=np.tile(n, (2, 1)),
        n2=np.tile(n, (2, 1)),
        mat_idx=np.full(2, material, np.int32),
    )


def sphere_field(
    n_side: int = 10,
    spacing: float = 3.0,
    n_lat: int = 24,
    n_lon: int = 48,
    material: int = 0,
) -> MeshData:
    """A grid of spheres baked into one big mesh — the ≥1M-triangle scene
    generator for BASELINE config 5 scaling sweeps."""
    base = uv_sphere(1.0, n_lat, n_lon, material)
    out: MeshData | None = None
    offset0 = -(n_side - 1) * spacing / 2
    for i in range(n_side):
        for j in range(n_side):
            m = np.eye(4, dtype=np.float32)
            m[3, :3] = (offset0 + i * spacing, 1.0, offset0 + j * spacing)
            inst = base.transformed(m)
            out = inst if out is None else out.concat(inst)
    assert out is not None
    return out
