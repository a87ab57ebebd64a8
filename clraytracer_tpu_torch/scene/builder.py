"""SceneBuilder for procedural scenes: the JAX package's builder
(``clraytracer_tpu/scene/builder.py``) with torch tensors as leaves.

Material 0 is the reference's prepared default (ResourceManager.cpp:224-232);
``DEFAULT_MATERIAL`` (0xFFFF) resolves to the instance's mesh material block
(Renderer.cpp:231-233). ``build`` makes the BVH forest (native builder
first, numpy fallback, selected as the JAX builder does), the cluster
tables, the texel pool and the packed shading tables, and returns an
immutable ``Scene`` whose leaves equal the JAX builder's. OBJ and ``.clm``
import are not ported yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from clraytracer_tpu_torch import math3d
from clraytracer_tpu_torch.bvh import build_bvh
from clraytracer_tpu_torch.config import PoolConfig
from clraytracer_tpu_torch.device import resolve_device
from clraytracer_tpu_torch.ops.clusters import (
    build_clusters,
    merge_cluster_ranges,
    subtree_cluster_ranges,
)
from clraytracer_tpu_torch.ops.shade import _OFF_MASK, _OFF_SHIFT
from clraytracer_tpu_torch.scene import procedural_tex as ptex
from clraytracer_tpu_torch.scene.procedural import MeshData
from clraytracer_tpu_torch.scene.textures import AtlasBuilder
from clraytracer_tpu_torch.scene.types import (
    BVH,
    Clusters,
    Instances,
    Materials,
    PackedTables,
    Scene,
    TextureAtlas,
    Triangles,
)

DEFAULT_MATERIAL = 0xFFFF
WHITE_TEXTURE = 0
BLACK_TEXTURE = 1

#: pools larger than this many texels also get the packed-RGB8 word copy
#: (``PackedTables.texels_u32``), as in the JAX builder
FLAT_TEXEL_MIN = 4_000_000


@dataclasses.dataclass
class _MatRec:
    albedo: np.ndarray
    specular: np.ndarray
    albedo_tex: int
    specular_tex: int
    shininess: float
    roughness: float
    transmission: float = 0.0


@dataclasses.dataclass
class _InstanceRec:
    mesh: int
    material_start: int
    transform: np.ndarray


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def pad8(mn: np.ndarray, mx: np.ndarray) -> np.ndarray:
    """Pack AABBs 16 per 128-wide row ([N, 8]: min xyz | max xyz | 2 pad),
    plus 32 inverted-empty padding boxes (min +BIG, max -BIG). Padding
    boxes PASS a conservative slab test; traversal masks them by count."""
    n = mn.shape[0]
    flat = np.concatenate(
        [mn, mx, np.zeros((n, 2), np.float32)], axis=1
    ).astype(np.float32)
    pad = (-n % 16) + 32
    empty = np.zeros((pad, 8), np.float32)
    empty[:, 0:3] = 1e30
    empty[:, 3:6] = -1e30
    return np.concatenate([flat, empty]).reshape(-1, 128)


class SceneBuilder:
    """Accumulates meshes, textures, materials and instances; ``build()``
    produces an immutable Scene."""

    def __init__(self, pools: PoolConfig | None = None) -> None:
        self.pools = pools or PoolConfig()
        self.atlas = AtlasBuilder(max_texels=self.pools.max_texel_bytes // 3)
        self._meshes: list[MeshData] = []
        self._mesh_material_start: list[int] = []
        self._materials: list[_MatRec] = []
        self._instances: list[_InstanceRec] = []
        self._procedurals: dict[int, ptex.ProceduralTexture] = {
            WHITE_TEXTURE: ptex.constant((255, 255, 255)),
            BLACK_TEXTURE: ptex.constant((0, 0, 0)),
        }
        # material 0: packed color 0x00FF0037, specular (250, 228, 210)
        self._materials.append(
            _MatRec(
                albedo=np.array([55, 0, 255], np.float32) / 255.0,
                specular=np.array([250, 228, 210], np.float32) / 255.0,
                albedo_tex=WHITE_TEXTURE,
                specular_tex=BLACK_TEXTURE,
                shininess=1.2,
                roughness=0.8,
            )
        )

    def create_material(
        self,
        albedo: tuple[float, float, float] = (1.0, 1.0, 1.0),
        specular: tuple[float, float, float] = (1.0, 1.0, 1.0),
        albedo_tex: int = WHITE_TEXTURE,
        specular_tex: int = WHITE_TEXTURE,
        shininess: float = 2.2,
        roughness: float = 0.6,
        transmission: float = 0.0,
    ) -> int:
        """ResourceManager::CreateMaterial equivalent; returns the handle."""
        if len(self._materials) >= self.pools.max_materials:
            raise MemoryError("material pool overflow (reference MaxMaterials)")
        self._materials.append(
            _MatRec(
                albedo=np.asarray(albedo, np.float32),
                specular=np.asarray(specular, np.float32),
                albedo_tex=albedo_tex,
                specular_tex=specular_tex,
                shininess=shininess,
                roughness=roughness,
                transmission=transmission,
            )
        )
        return len(self._materials) - 1

    def import_texture(self, rgb8: np.ndarray) -> int:
        """Append an [H, W, 3] u8 image to the texel pool; returns its
        handle. Scenes with such textures render on a path this package
        does not port yet (``render.render_frame`` raises)."""
        if len(self.atlas._width) >= self.pools.max_textures:
            raise MemoryError("texture pool overflow (reference MaxTextures)")
        return self.atlas.add_image(rgb8)

    def import_procedural(self, desc: ptex.ProceduralTexture) -> int:
        """Register a procedural texture: baked into the pool like any image
        AND recorded as a descriptor the frame evaluates per ray."""
        handle = self.import_texture(ptex.bake(desc))
        self._procedurals[handle] = desc
        return handle

    def add_mesh(self, mesh: MeshData, materials_start: int | None = None) -> int:
        """Add a triangle soup; returns the mesh handle."""
        total = sum(m.count for m in self._meshes) + mesh.count
        if total > self.pools.max_triangles:
            raise MemoryError("triangle pool overflow (reference MAX_TRIANGLES)")
        self._meshes.append(mesh)
        self._mesh_material_start.append(
            0 if materials_start is None else materials_start
        )
        return len(self._meshes) - 1

    def add_instance(
        self,
        mesh: int,
        transform: np.ndarray | None = None,
        material: int = DEFAULT_MATERIAL,
    ) -> int:
        """RegisterMeshInstance equivalent (Renderer.cpp:226-241)."""
        if len(self._instances) >= self.pools.max_instances:
            raise MemoryError("instance pool overflow (reference MaxNumInstances)")
        if material == DEFAULT_MATERIAL:
            material = self._mesh_material_start[mesh]
        m = np.eye(4, dtype=np.float32) if transform is None else np.asarray(
            transform, np.float32
        )
        self._instances.append(
            _InstanceRec(mesh=mesh, material_start=material, transform=m)
        )
        return len(self._instances) - 1

    def build(
        self,
        max_leaf: int | None = 4,
        min_leaf: int = 1,
        device: str | torch.device | None = None,
    ) -> Scene:
        """Build BVHs and every table; returns the Scene on ``device``
        (None = the CUDA card)."""
        dev = resolve_device(device)
        assert self._meshes, "no meshes added"
        concat = self._meshes[0]
        for m in self._meshes[1:]:
            concat = concat.concat(m)
        counts = [m.count for m in self._meshes]

        # native builder first, numpy level-synchronous build as the fallback
        from clraytracer_tpu_torch.runtime.fastobj import build_bvh_native

        build = build_bvh_native(
            concat.v0, concat.v1, concat.v2, counts,
            min_leaf=min_leaf, max_leaf=max_leaf,
        )
        if build is None:
            build = build_bvh(
                concat.v0, concat.v1, concat.v2, counts,
                min_leaf=min_leaf, max_leaf=max_leaf,
            )
        p = build.perm
        hv0, hv1, hv2 = concat.v0[p], concat.v1[p], concat.v2[p]
        h_uv = [math3d.to_half(concat.uv0[p]), math3d.to_half(concat.uv1[p]),
                math3d.to_half(concat.uv2[p])]
        h_n = [math3d.to_half(concat.n0[p]), math3d.to_half(concat.n1[p]),
               math3d.to_half(concat.n2[p])]
        h_mat_idx = concat.mat_idx[p]

        tris = Triangles(
            v0=_t(hv0), v1=_t(hv1), v2=_t(hv2),
            uv0=_t(h_uv[0]), uv1=_t(h_uv[1]), uv2=_t(h_uv[2]),
            n0=_t(h_n[0]), n1=_t(h_n[1]), n2=_t(h_n[2]),
            mat_idx=_t(h_mat_idx),
        )
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64)
        bvh = BVH(
            node_min=_t(build.node_min),
            node_max=_t(build.node_max),
            left_first=_t(build.left_first),
            tri_count=_t(build.tri_count),
            roots=tuple(int(r) for r in build.roots),
            mesh_tri_start=tuple(int(s) for s in starts),
            mesh_tri_count=tuple(int(cn) for cn in counts),
            max_leaf_size=int(build.tri_count.max(initial=1)),
        )

        texels_u8, width, height, offset = self.atlas.build()
        # bytes * f32(1/255), the product the per-ray texel formula uses
        atlas = TextureAtlas(
            texels=_t(
                np.concatenate(
                    [
                        texels_u8.astype(np.float32) * np.float32(1.0 / 255.0),
                        np.zeros((texels_u8.shape[0], 1), np.float32),
                    ],
                    axis=1,
                )
            ),
            width=_t(width),
            height=_t(height),
            offset=_t(offset),
        )

        albedo = np.stack([m.albedo for m in self._materials])
        specular = np.stack([m.specular for m in self._materials])
        f32 = lambda xs: _t(np.asarray(xs, np.float32))
        i32 = lambda xs: _t(np.asarray(xs, np.int32))
        materials = Materials(
            albedo=_t(albedo),
            specular=_t(specular),
            albedo_tex=i32([m.albedo_tex for m in self._materials]),
            specular_tex=i32([m.specular_tex for m in self._materials]),
            shininess=f32([m.shininess for m in self._materials]),
            roughness=f32([m.roughness for m in self._materials]),
            color_u32=_t(math3d.pack_rgb_u32(albedo).astype(np.uint32)),
            specular_u32=_t(math3d.pack_rgb_u32(specular).astype(np.uint32)),
            transmission=f32([m.transmission for m in self._materials]),
        )

        skybox = 2 if self.atlas.num_textures > 2 else WHITE_TEXTURE
        if self._instances:
            inv = np.stack(
                [np.linalg.inv(r.transform).astype(np.float32)
                 for r in self._instances]
            )
            mat_start = np.array(
                [r.material_start for r in self._instances], np.int32
            )
        else:
            inv = np.zeros((0, 4, 4), np.float32)
            mat_start = np.zeros(0, np.int32)
        instances = Instances(
            inverse_transform=_t(inv),
            material_start=_t(mat_start),
            mesh_index=tuple(int(r.mesh) for r in self._instances),
        )
        h_tri_attr = np.concatenate(
            [np.asarray(a, np.float32) for a in (*h_n, *h_uv)]
            + [np.asarray(h_mat_idx, np.float32)[:, None]],
            axis=1,
        )
        packed = self._packed_tables(
            h_tri_attr, inv, mat_start, albedo, specular, width, height,
            offset, skybox,
        )
        if texels_u8.shape[0] > FLAT_TEXEL_MIN:
            w32 = (
                texels_u8[:, 0].astype(np.uint32)
                | (texels_u8[:, 1].astype(np.uint32) << 8)
                | (texels_u8[:, 2].astype(np.uint32) << 16)
            )
            packed = dataclasses.replace(
                packed, texels_u32=_t(w32.astype(np.int32))
            )

        ct = build_clusters(
            hv0, hv1, hv2, bvh.mesh_tri_start, bvh.mesh_tri_count,
            attrs=h_tri_attr,
            cluster_ranges=[
                merge_cluster_ranges(
                    subtree_cluster_ranges(
                        build.left_first, build.tri_count, int(root)
                    ),
                    hv0, hv1, hv2,
                )
                for root in build.roots
            ],
        )
        clusters = Clusters(
            tri_a=_t(ct.tri_a), tri_b=_t(ct.tri_b), tri_c=_t(ct.tri_c),
            at_a=_t(ct.at_a), at_b=_t(ct.at_b), at_c=_t(ct.at_c),
            at_d=_t(ct.at_d),
            tri_gid=_t(ct.tri_gid),
            cluster_aabb=_t(pad8(ct.cluster_min, ct.cluster_max)),
            super_aabb=_t(pad8(ct.super_min, ct.super_max)),
            hyper_aabb=_t(pad8(ct.hyper_min, ct.hyper_max)),
            mesh_ranges=ct.mesh_ranges,
        )
        procedural = tuple(
            sorted(
                (h, int(offset[h]), desc)
                for h, desc in self._procedurals.items()
            )
        )
        scene = Scene(
            clusters=clusters,
            tris=tris,
            bvh=bvh,
            materials=materials,
            atlas=atlas,
            instances=instances,
            packed=packed,
            skybox_tex=skybox,
            procedural_tex=procedural,
        )
        return scene.to(dev)

    def _packed_tables(
        self,
        h_tri_attr: np.ndarray,
        inv: np.ndarray,
        mat_start: np.ndarray,
        albedo: np.ndarray,
        specular: np.ndarray,
        tex_width: np.ndarray,
        tex_height: np.ndarray,
        tex_offset: np.ndarray,
        skybox: int,
    ) -> PackedTables:
        """The gather-friendly tables (``PackedTables``), built on the host."""
        if self._instances:
            inst_rows = np.concatenate(
                [inv.reshape(-1, 16), mat_start.astype(np.float32)[:, None]],
                axis=1,
            )
        else:
            inst_rows = np.zeros((1, 17), np.float32)

        texrec = lambda ti: np.stack(
            [
                tex_width[ti],
                tex_height[ti],
                tex_offset[ti] >> _OFF_SHIFT,
                tex_offset[ti] & _OFF_MASK,
            ],
            axis=1,
        ).astype(np.float32)
        a_tex = np.array([m.albedo_tex for m in self._materials])
        s_tex = np.array([m.specular_tex for m in self._materials])
        mat_rows = np.concatenate(
            [
                albedo,
                specular,
                np.array(
                    [[m.shininess, m.roughness] for m in self._materials],
                    np.float32,
                ),
                texrec(a_tex),
                texrec(s_tex),
            ],
            axis=1,
        ).astype(np.float32)

        return PackedTables(
            tri_attr=_t(h_tri_attr),
            inst_rows=_t(inst_rows),
            mat_rows=_t(mat_rows),
            skybox_w=int(tex_width[skybox]),
            skybox_h=int(tex_height[skybox]),
            skybox_off=int(tex_offset[skybox]),
        )
