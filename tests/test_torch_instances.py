"""The port with its instance pool full (``PoolConfig.max_instances``, the
upstream's ``MaxNumInstances`` = 401, Renderer.hpp:16) on the CPU: 401
instances of one small textured mesh under seeded rigid transforms, at
64x48. Through ``Engine`` (K2.2's and K2.1's plain versions) against the
benchmark's plain reference (``rtbench.reference.frame``, plain torch, no
JAX) under the benchmark's pixel and pick rules (``rtbench.check``); the
instance table after edits against a fresh inversion of every transform,
bit for bit; the 401st instance in the frame and the 402nd refused."""

import numpy as np
import pytest
import torch

from clraytracer_tpu_torch.engine import Engine
from rtbench import check, port
from rtbench.cells import HERE
from rtbench.poses import Pose
from rtbench.reference.frame import Scene as RefScene
from rtbench.scenes.geometry import uv_sphere
from rtbench.scenes.spec import Instance, Material, Texture, base_spec, translation
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

SEED = 2**31 + 401
CONFIG = {"width": 64, "height": 48, "bounces": 2, "sun_angle": -1.96}
POSE = Pose((0.0, 0.0, 12.0), -90.0, 0.0)
#: the last instance, the 401st: put in front of the camera, at the frame's
#: centre
LAST = 400


def _rigid(rng: np.random.Generator) -> np.ndarray:
    """A seeded rotation (a unit quaternion) and a translation in the box
    the camera looks at, in the row-vector convention (v @ M)."""
    q = rng.normal(size=4)
    w, x, y, z = q / np.linalg.norm(q)
    r = np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                  [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                  [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = r.T
    m[3, :3] = rng.uniform((-6.0, -4.0, -10.0), (6.0, 4.0, 2.0))
    return m


def _spec(rng: np.random.Generator):
    """401 instances of a 96-triangle sphere (three clusters: the plain
    versions test every slot of every instance) with an imported map (atlas
    mode 1); the last one in front of the camera at the frame's centre."""
    spec = base_spec(32, (64, 32))
    spec.textures.append(Texture(image=rng.integers(0, 256, (16, 16, 3), dtype=np.uint8)))
    spec.materials.append(Material(albedo=(0.9, 0.7, 0.5), albedo_tex=len(spec.textures) - 1))
    spec.meshes.append(uv_sphere(0.6, n_lat=5, n_lon=12))
    for k in range(LAST + 1):
        m = _rigid(rng) if k < LAST else translation(0.0, 0.0, 6.0)
        spec.instances.append(Instance(mesh=0, transform=m, material_start=1))
    return spec


@pytest.fixture(scope="module")
def pool():
    """The engine over the full pool after a tick that edits a seeded
    handful of instances, the spec holding the same transforms, and the
    picks' points."""
    rng = np.random.default_rng(SEED)
    spec = _spec(rng)
    eng = Engine(port.builder(spec), port.render_config(CONFIG), device="cpu")
    eng.start()
    port.set_pose(eng, POSE)
    for k in sorted(rng.choice(LAST, 7, replace=False).tolist()):
        m = _rigid(rng)
        spec.instances[k].transform = m
        eng.set_instance_transform(k, m)
    eng.tick()
    # inside the part of the frame that the crowd covers
    xy = [(float(rng.integers(12, 52)), float(rng.integers(14, 38))) for _ in range(15)]
    return eng, spec, xy + [(32.0, 24.0)]


def test_instance_table_is_a_fresh_inversion_after_edits(pool):
    eng, spec, _ = pool
    fresh = np.stack([np.linalg.inv(i.transform).astype(np.float32) for i in spec.instances])
    got = eng.builder.instance_arrays(device="cpu").inverse_transform.numpy()
    assert got.shape == (LAST + 1, 4, 4) and got.tobytes() == fresh.tobytes()
    assert eng.scene.instances.inverse_transform.numpy().tobytes() == fresh.tobytes()


def test_full_pool_frame_and_picks_match_the_reference(pool):
    eng, spec, xy = pool
    img = eng.render()
    picks = [eng.pick(x, y) for x, y in xy]
    ref = RefScene(spec, torch.device("cpu"))
    py, px = torch.meshgrid(torch.arange(48.0), torch.arange(64.0), indexing="ij")
    px, py = px.reshape(-1), py.reshape(-1)
    want = ref.frame_pixels(POSE, CONFIG, px, py)
    off = check.pixels_off(img[py.long(), px.long()], want)
    assert off <= check.limits(HERE, "instances401-walk")["pixels_off"], off
    disagree = [(x, y) for (x, y), hit in zip(xy, picks)
                if check.pick_disagrees(hit, ref.pick(POSE, CONFIG, x, y))]
    assert disagree == []
    hit_instances = {int(h.instance) for h in picks if h.hit}
    assert len(hit_instances) >= 8, hit_instances
    # the 401st instance is in the frame: the centre's pick hits it
    assert picks[-1].hit and int(picks[-1].instance) == LAST


def test_the_402nd_instance_is_refused(pool):
    eng, _, _ = pool
    with pytest.raises(MemoryError):
        eng.builder.add_instance(0)
    assert eng.builder.instance_arrays(device="cpu").inverse_transform.shape[0] == LAST + 1
