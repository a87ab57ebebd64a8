"""Scene data model: dataclasses of tensors.

The same fields, names, shapes and dtypes as the JAX package's pytrees
(``clraytracer_tpu/scene/types.py``), so a scene carries across leaf for
leaf (scene/bridge.py). Host-side ints and tuples (mesh ranges, the
procedural-texture registry, the skybox record) stay Python values.
``.to(device)`` moves every tensor.
"""

from __future__ import annotations

import dataclasses

import torch

#: Miss sentinel distance (reference RayacastMissDistance=1e30).
MISS_DISTANCE = 1e30


class _TensorData:
    """``.to(device)`` over every tensor field (nested dataclasses too)."""

    def to(self, device: str | torch.device):
        def move(v):
            if isinstance(v, torch.Tensor):
                return v.to(device)
            if isinstance(v, _TensorData):
                return v.to(device)
            return v

        return dataclasses.replace(
            self,
            **{f.name: move(getattr(self, f.name)) for f in dataclasses.fields(self)},
        )

    @property
    def device(self) -> torch.device:
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, (torch.Tensor, _TensorData)):
                return v.device
        raise ValueError("no tensor fields")


@dataclasses.dataclass(frozen=True)
class Triangles(_TensorData):
    """Triangle soup, SoA; uv*/n* are float16 like the reference's half
    attributes (AssetManager.cpp:270-274)."""

    v0: torch.Tensor  # [T, 3] f32
    v1: torch.Tensor
    v2: torch.Tensor
    uv0: torch.Tensor  # [T, 2] f16
    uv1: torch.Tensor
    uv2: torch.Tensor
    n0: torch.Tensor  # [T, 3] f16
    n1: torch.Tensor
    n2: torch.Tensor
    mat_idx: torch.Tensor  # [T] i32, local to the owning mesh

    @property
    def count(self) -> int:
        return self.v0.shape[0]


@dataclasses.dataclass(frozen=True)
class BVH(_TensorData):
    """Flattened BVH forest, one root per mesh (reference BVH.cpp:239-252)."""

    node_min: torch.Tensor  # [N, 3] f32
    node_max: torch.Tensor  # [N, 3] f32
    left_first: torch.Tensor  # [N] i32
    tri_count: torch.Tensor  # [N] i32
    roots: tuple[int, ...] = ()
    mesh_tri_start: tuple[int, ...] = ()
    mesh_tri_count: tuple[int, ...] = ()
    max_leaf_size: int = 0


@dataclasses.dataclass(frozen=True)
class TextureAtlas(_TensorData):
    """Packed texel pool with {width, height, offset} records."""

    texels: torch.Tensor  # [P, 4] f32 in [0, 1] (4th column zero)
    width: torch.Tensor  # [K] i32
    height: torch.Tensor  # [K] i32
    offset: torch.Tensor  # [K] i32

    @property
    def num_textures(self) -> int:
        return self.width.shape[0]


@dataclasses.dataclass(frozen=True)
class Materials(_TensorData):
    """Material table (reference Material, ResourceManager.hpp:44-51)."""

    albedo: torch.Tensor  # [M, 3] f32
    specular: torch.Tensor  # [M, 3] f32
    albedo_tex: torch.Tensor  # [M] i32
    specular_tex: torch.Tensor  # [M] i32
    shininess: torch.Tensor  # [M] f32
    roughness: torch.Tensor  # [M] f32
    color_u32: torch.Tensor  # [M] u32 packed 0x00BBGGRR
    specular_u32: torch.Tensor  # [M] u32
    transmission: torch.Tensor  # [M] f32

    @property
    def count(self) -> int:
        return self.albedo.shape[0]


@dataclasses.dataclass(frozen=True)
class Instances(_TensorData):
    """Mesh instances with cached inverse transforms (row-vector
    convention, reference Renderer.hpp:6-10)."""

    inverse_transform: torch.Tensor  # [I, 4, 4] f32
    material_start: torch.Tensor  # [I] i32
    mesh_index: tuple[int, ...] = ()

    @property
    def count(self) -> int:
        return self.inverse_transform.shape[0]


@dataclasses.dataclass(frozen=True)
class Clusters(_TensorData):
    """Cluster tables (ops/clusters.py). ``tri_a``/``tri_b``/``tri_c`` hold
    the N, U and V intersection planes, 32 triangles per row per component;
    ``at_a``..``at_d`` the shading attributes in the same packing. AABBs
    are packed 16 boxes per 128-wide row (box ``i`` = row ``i // 16``, cols
    ``(i % 16) * 8 + [0, 6)``: min xyz | max xyz); padding boxes are
    inverted-empty."""

    tri_a: torch.Tensor  # [C, 128] f32: Nx|Ny|Nz|Nw
    tri_b: torch.Tensor  # [C, 128] f32: Ux|Uy|Uz|Uw
    tri_c: torch.Tensor  # [C, 128] f32: Vx|Vy|Vz|Vw
    at_a: torch.Tensor  # [C, 128] f32: n0x|n0y|n0z|n1x
    at_b: torch.Tensor  # [C, 128] f32: n1y|n1z|n2x|n2y
    at_c: torch.Tensor  # [C, 128] f32: n2z|uv0u|uv0v|uv1u
    at_d: torch.Tensor  # [C, 128] f32: uv1v|uv2u|uv2v|mat_local
    tri_gid: torch.Tensor  # [C*32] i32: slot → arena triangle index
    cluster_aabb: torch.Tensor  # [ceil(C/16)+2, 128] f32
    super_aabb: torch.Tensor  # [ceil(S/16)+2, 128] f32
    #: the JAX package's HBM-streaming copy of the seven tables; carried by
    #: the bridge, never built or read here (the CUDA kernels read global
    #: memory directly, whatever the scene size)
    geo_stream: torch.Tensor | None = None
    hyper_aabb: torch.Tensor | None = None  # [ceil(H/16)+2, 128] f32
    #: per-mesh (super_start, super_count, cluster_start, cluster_count)
    mesh_ranges: tuple[tuple[int, int, int, int], ...] = ()


@dataclasses.dataclass(frozen=True)
class PackedTables(_TensorData):
    """Gather-friendly derived tables (column layouts as the JAX package's
    ``ops/shade.ShadingTables``)."""

    tri_attr: torch.Tensor  # [T, 16] f32: n0 n1 n2 | uv0 uv1 uv2 | mat_local
    inst_rows: torch.Tensor  # [I, 17] f32: inverse transform | mat_start
    mat_rows: torch.Tensor  # [M, 16] f32: albedo spec shin rough | tex recs
    skybox_w: int = 1
    skybox_h: int = 1
    skybox_off: int = 0
    texels_u32: torch.Tensor | None = None  # [P] i32 packed RGB8


@dataclasses.dataclass(frozen=True)
class Scene(_TensorData):
    """Complete renderable scene state."""

    tris: Triangles
    bvh: BVH
    materials: Materials
    atlas: TextureAtlas
    instances: Instances
    clusters: Clusters | None = None
    packed: PackedTables | None = None
    skybox_tex: int = 2
    #: (texture handle, texel-pool offset, ProceduralTexture) triples
    procedural_tex: tuple = ()
