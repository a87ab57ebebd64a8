"""The port's frame loop with sun shadows on the CPU (K2.2's plain version,
whose shadow ray is a nearest-hit ``trace_plain``), against the
benchmark's plain reference with the shadow ray
(``rtbench.reference.shadows``, plain torch, no JAX) under the limits of
the cell ``museum160k-shadows-walk`` (``rtbench.check``).

The scene is small and in atlas mode 1, as the museum is: a floor with an
imported map, a field of nine spheres, and the same field raised and turned
as a third instance, so that the shadow rays of its hits start at the
object-space points that the upstream reuses as world origins. The camera
stands off the scene's symmetry planes: a ray exactly on an edge shared by
two triangles is the crack on exact edges, a fault of its own (PERF.md §7).
"""

import math

import numpy as np
import pytest
import torch

from clraytracer_tpu_torch.engine import Engine
from rtbench import check, port
from rtbench.cells import HERE
from rtbench.poses import Pose
from rtbench.reference.camera import pixel_rays
from rtbench.reference.shadows import Scene as RefScene
from rtbench.scenes.geometry import _quad_grid, sphere_field
from rtbench.scenes.spec import Instance, Material, Texture, base_spec, rotation_y, translation
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

SEED = 2**31 + 22
CONFIG = {"width": 64, "height": 48, "bounces": 2, "sun_angle": -1.96,
          "render": {"enable_shadows": True}}
POSE = Pose((0.13, 9.0, 8.0), -90.0, -48.0)
RAISED = 2
LIMITS = check.limits(HERE, "museum160k-shadows-walk")


def _spec(rng: np.random.Generator):
    spec = base_spec(8, (64, 32))
    spec.textures.append(Texture(image=rng.integers(0, 256, (16, 16, 3), dtype=np.uint8)))
    spec.materials.append(Material(albedo=(0.9, 0.8, 0.7), albedo_tex=len(spec.textures) - 1))
    spec.materials.append(Material(albedo=(0.6, 0.7, 0.9)))
    spec.meshes.append(_quad_grid(4, (-6.0, 0.0, -6.0), (12.0, 0.0, 0.0), (0.0, 0.0, 12.0),
                                  (0.0, 1.0, 0.0), 2.0))
    spec.meshes.append(sphere_field(3, 2.5, 6, 12))
    spec.instances.append(Instance(mesh=0, transform=translation(0.0, 0.0, 0.0), material_start=1))
    spec.instances.append(Instance(mesh=1, transform=translation(0.0, 0.0, 0.0), material_start=2))
    spec.instances.append(Instance(mesh=1, transform=translation(0.5, 2.5, 0.5), material_start=2))
    return spec


@pytest.fixture(scope="module")
def walked():
    """The engine with shadows on after one edit (the raised field turned
    20 degrees) and one tick, its frame and picks, the spec holding the
    same transforms, and the picks' points."""
    rng = np.random.default_rng(SEED)
    spec = _spec(rng)
    eng = Engine(port.builder(spec), port.render_config(CONFIG), device="cpu")
    eng.start()
    port.set_pose(eng, POSE)
    m = (rotation_y(math.radians(20.0)) @ spec.instances[RAISED].transform).astype(np.float32)
    spec.instances[RAISED].transform = m
    eng.set_instance_transform(RAISED, m)
    eng.tick()
    img = eng.render()
    xy = [(float(rng.integers(8, 56)), float(rng.integers(6, 42))) for _ in range(16)]
    return spec, img, [eng.pick(x, y) for x, y in xy], xy


def _pixels():
    py, px = torch.meshgrid(torch.arange(48.0), torch.arange(64.0), indexing="ij")
    return px.reshape(-1), py.reshape(-1)


def test_shadowed_frame_and_picks_match_the_reference(walked):
    spec, img, picks, xy = walked
    px, py = _pixels()
    got = img[py.long(), px.long()]
    ref = RefScene(spec, torch.device("cpu"))
    off = check.pixels_off(got, ref.frame_pixels(POSE, CONFIG, px, py))
    assert off <= LIMITS["pixels_off"], off
    disagree = [p for p, hit in zip(xy, picks)
                if check.pick_disagrees(hit, ref.pick(POSE, CONFIG, *p))]
    assert len(disagree) / len(xy) <= LIMITS["picks_off"], disagree
    assert sum(bool(h.hit) for h in picks) >= 8
    # the same reference without its shadow ray fails the cell's limit:
    # the port's frame holds the shadows
    unshadowed = RefScene(spec, torch.device("cpu"), shadows=False)
    off_unshadowed = check.pixels_off(got, unshadowed.frame_pixels(POSE, CONFIG, px, py))
    assert off_unshadowed > 10 * LIMITS["pixels_off"], off_unshadowed


def test_the_shadows_matter(walked):
    """Between 10% and 90% of the hits are occluded, and the raised field
    is in the frame."""
    spec, _, _, _ = walked
    ref = RefScene(spec, torch.device("cpu"))
    px, py = _pixels()
    o, d = pixel_rays(POSE, 64, 48, px, py, torch.float32)
    records, occluders = [], []
    ref.radiance(o, d, CONFIG["sun_angle"], CONFIG["bounces"], records, occluders)
    hits = records[0][0]
    (occ_inst, _), = occluders
    assert 0.1 <= occ_inst.numel() / hits.numel() <= 0.9, (occ_inst.numel(), hits.numel())
    assert int((hits == RAISED).sum()) > 100
