"""SceneBuilder for procedural scenes: the JAX package's builder
(``clraytracer_tpu/scene/builder.py``) with torch tensors as leaves.

Material 0 is the reference's prepared default (ResourceManager.cpp:224-232);
``DEFAULT_MATERIAL`` (0xFFFF) resolves to the instance's mesh material block
(Renderer.cpp:231-233). ``build`` makes the BVH forest (native builder
first, numpy fallback, selected as the JAX builder does), the cluster
tables, the texel pool and the packed shading tables, and returns an
immutable ``Scene`` whose leaves equal the JAX builder's. ``import_mesh``
reads OBJ/MTL, ``.clm`` and ``.clmz`` files with their textures.
"""

from __future__ import annotations

import dataclasses
import logging
from pathlib import Path

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
from clraytracer_tpu_torch.scene import cache as mesh_cache
from clraytracer_tpu_torch.scene import procedural_tex as ptex
from clraytracer_tpu_torch.scene.clm import resolve_asset_path
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
from clraytracer_tpu_torch.utils.timer import ScopeTimer

DEFAULT_MATERIAL = 0xFFFF
NONE_MATERIAL = 0
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


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _inverse(transform: np.ndarray) -> np.ndarray:
    """One instance's inverse transform, in an ``engine.inverse`` span: a
    traced run counts the inversions by its ranges."""
    with ScopeTimer("engine.inverse", log=False):
        return np.linalg.inv(transform).astype(np.float32)


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


class _RowUpload:
    """The tick's upload of the instance rows: kept pinned blocks, used in
    turn, each written again only once the copy that read it has run (its
    event), and cut anew when the instance count changes."""

    BLOCKS = 3

    def __init__(self) -> None:
        self._count = -1  # the instance count the blocks hold
        self._blocks: list[torch.Tensor] = []  # pinned [I, 17] f32
        self._host: list[np.ndarray] = []  # their numpy views
        self._events: list = []
        self._stream = None  # the torch stream the copies were queued on
        self._next = 0

    def __call__(self, rows: np.ndarray, dev: torch.device) -> torch.Tensor:
        from clraytracer_tpu_torch.runtime.kernels import stream_handle

        if rows.shape[0] != self._count:
            self._cut(rows.shape[0])
        k = self._next
        self._next = (k + 1) % self.BLOCKS
        self._events[k].synchronize()  # the copy that last read block k has run
        np.copyto(self._host[k], rows)
        out = self._blocks[k].to(dev, non_blocking=True)
        if self._stream is None or self._stream.cuda_stream != stream_handle(out.device):
            self._stream = torch.cuda.current_stream(out.device)
        self._events[k].record(self._stream)
        return out

    def _cut(self, n: int) -> None:
        for event in self._events:
            event.synchronize()
        self._blocks = [torch.empty((n, 17), dtype=torch.float32, pin_memory=True)
                        for _ in range(self.BLOCKS)]
        self._host = [b.numpy() for b in self._blocks]
        self._events = [torch.cuda.Event() for _ in range(self.BLOCKS)]
        self._count = n


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
        #: [I, 17] f32 instance rows kept between ticks (the kernels' layout:
        #: inverse transform | material start): an edit inverts only the
        #: instance it changes and writes its row
        self._rows = np.zeros((0, 17), np.float32)
        #: each instance's mesh, one tuple until the next ``add_instance``
        self.mesh_index: tuple[int, ...] = ()
        self._upload = _RowUpload()
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

    def edit_material(self, handle: int, **updates: object) -> None:
        """Live material editing (reference EditMaterial +
        PushMaterialsToGPU, ResourceManager.cpp:102-143): the next build
        carries the updated record."""
        rec = self._materials[handle]
        for k, v in updates.items():
            if not hasattr(rec, k):
                raise AttributeError(k)
            setattr(rec, k, np.asarray(v, np.float32) if k in ("albedo", "specular") else v)

    def import_texture(self, source: str | Path | np.ndarray) -> int:
        """Append an [H, W, 3] u8 image, or decode an image file
        (``AtlasBuilder.load_image``), to the texel pool; returns its
        handle."""
        if len(self.atlas._width) >= self.pools.max_textures:
            raise MemoryError("texture pool overflow (reference MaxTextures)")
        if isinstance(source, np.ndarray):
            return self.atlas.add_image(source)
        return self.atlas.load_image(source)

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

    def import_mesh(self, path: str | Path, use_cache: bool = True) -> int:
        """Import an OBJ, ``.clm`` or cached mesh (``cache.import_mesh``)
        and register its materials and their diffuse and specular maps
        (reference ImportMesh, ResourceManager.cpp:241-276); returns the
        mesh handle. A map that cannot be found stays ``WHITE_TEXTURE``,
        with a warning for a diffuse map."""
        path = Path(path)
        obj = mesh_cache.import_mesh(path, use_cache=use_cache)
        mat_start = len(self._materials) if obj.materials else 0
        for om in obj.materials:
            albedo_tex = WHITE_TEXTURE
            specular_tex = WHITE_TEXTURE
            if om.diffuse_map:
                # .clm/.mtl paths may be project-root relative and in Windows
                # case ("Assets/sponza/01_ST_KP.JPG"): resolve both forms
                tex_path = resolve_asset_path(path.parent, om.diffuse_map)
                if tex_path is not None:
                    albedo_tex = self.import_texture(tex_path)
                else:
                    logging.getLogger(__name__).warning(
                        "missing diffuse map %s (near %s)", om.diffuse_map, path
                    )
            if om.specular_map:
                tex_path = resolve_asset_path(path.parent, om.specular_map)
                if tex_path is not None:
                    specular_tex = self.import_texture(tex_path)
            self.create_material(
                albedo=tuple(om.diffuse),
                specular=tuple(om.specular),
                albedo_tex=albedo_tex,
                specular_tex=specular_tex,
                shininess=om.shininess,
                roughness=om.roughness,
            )
        return self.add_mesh(obj.mesh, materials_start=mat_start)

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
        row = np.append(_inverse(m).reshape(16), np.float32(material))
        self._instances.append(_InstanceRec(mesh=mesh, material_start=material))
        self._rows = np.concatenate([self._rows, row[None]])
        self.mesh_index = self.mesh_index + (int(mesh),)
        return len(self._instances) - 1

    def set_instance_transform(self, handle: int, transform: np.ndarray) -> None:
        """SetMeshMatrix equivalent (Renderer.cpp:288-298): the instance's
        inverse is computed here, once, into the instance's kept row; the
        next ``instance_rows`` or ``instance_arrays`` carries it."""
        self._rows[handle, :16] = _inverse(np.asarray(transform, np.float32)).reshape(16)

    def _instance_host(self) -> tuple[np.ndarray, np.ndarray]:
        """The instances' inverse transforms [I, 4, 4] (a copy of the kept
        rows, which later edits overwrite) and material starts [I], on the
        host."""
        mat_start = np.array([r.material_start for r in self._instances], np.int32)
        return self._rows[:, :16].reshape(-1, 4, 4).copy(), mat_start

    def instance_rows(self, device: str | torch.device | None = None) -> torch.Tensor:
        """The kept instance rows [I, 17] f32 (inverse transform | material
        start, ``PackedTables.inst_rows``' layout) on ``device`` (None = the
        CUDA card), as a new tensor: the tick's one upload. A copy to the
        card leaves from a kept pinned block without waiting for the frames
        queued before it."""
        dev = resolve_device(device)
        if dev.type == "cuda":
            return self._upload(self._rows, dev)
        return torch.from_numpy(self._rows.copy())

    def instance_arrays(self, device: str | torch.device | None = None) -> Instances:
        """The instance table on ``device`` (None = the CUDA card): the
        analogue of the reference's dirty-range upload (Renderer.cpp:312-
        320). A copy to the card leaves from pinned memory without waiting
        for the frames queued before it."""
        dev = resolve_device(device)
        inv, mat_start = self._instance_host()

        def up(a: np.ndarray) -> torch.Tensor:
            t = _t(a)
            if dev.type == "cuda":
                return t.pin_memory().to(dev, non_blocking=True)
            return t

        return Instances(
            inverse_transform=up(inv),
            material_start=up(mat_start),
            mesh_index=self.mesh_index,
        )

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
        inv, mat_start = self._instance_host()
        instances = Instances(
            inverse_transform=_t(inv),
            material_start=_t(mat_start),
            mesh_index=self.mesh_index,
        )
        h_tri_attr = np.concatenate(
            [np.asarray(a, np.float32) for a in (*h_n, *h_uv)]
            + [np.asarray(h_mat_idx, np.float32)[:, None]],
            axis=1,
        )
        packed = self._packed_tables(
            h_tri_attr, albedo, specular, width, height, offset, skybox,
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
        albedo: np.ndarray,
        specular: np.ndarray,
        tex_width: np.ndarray,
        tex_height: np.ndarray,
        tex_offset: np.ndarray,
        skybox: int,
    ) -> PackedTables:
        """The gather-friendly tables (``PackedTables``), built on the host."""
        inst_rows = self._rows.copy() if self._instances else np.zeros((1, 17), np.float32)

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
