"""The comparison fails what it should: a run with the timed path broken
underneath (each fault the cell can have) comes out not correct, and so
does the control, the reference in bfloat16 in the program's place."""

from __future__ import annotations

import json

import pytest
import torch

from rtbench import cells, check, loops
from rtbench.tests.conftest import make_checkout, run_cell

FRAME = "import clraytracer_tpu_torch.engine as E\nreal = E.render_frame\n"
PICK = "import clraytracer_tpu_torch.engine as E\nreal = E.pick\n"
STEP = "import clraytracer_tpu_torch.diff as D\nreal = D.image_loss_and_grads\n"

FAULTS = {
    # a frame's answer altered where it is produced: every 8th row brighter
    "walk-altered": ("sphere1m-walk", FRAME + """
def broken(*a, **k):
    img = real(*a, **k)
    img[::8, :, 0] += 0.05
    return img
E.render_frame = broken
"""),
    # half of the frame left out: the upper rows never rendered
    "walk-half": ("sphere1m-walk", FRAME + """
def broken(*a, **k):
    img = real(*a, **k)
    img[img.shape[0] // 2:] = 0.0
    return img
E.render_frame = broken
"""),
    # a step that returns its state unchanged: each frame the image of the
    # frame before it
    "walk-stale": ("sphere1m-walk", FRAME + """
last = []
def broken(*a, **k):
    img = real(*a, **k)
    out = last[0] if last else img
    last[:] = [img.clone()]
    return out
E.render_frame = broken
"""),
    # a pick's answer altered: hit and miss swapped
    "walk-pick": ("sphere1m-walk", PICK + """
def broken(*a, **k):
    rec = real(*a, **k)
    return rec._replace(hit=~rec.hit)
E.pick = broken
"""),
    # half of the batch left out: the loss is the mean over half the rows
    "grads-half": ("sphere1m-grads", STEP + """
def broken(scene, frame, w, h, target=None, **k):
    return real(scene, frame, w, h, device=k.get("device"),
                loss_fn=lambda img: ((img[: h // 2] - target[: h // 2]) ** 2).mean())
D.image_loss_and_grads = broken
"""),
    # an answer altered where it is produced: one leaf's gradient
    # accumulated twice
    "grads-altered": ("sphere1m-grads", STEP + """
def broken(*a, **k):
    loss, grads = real(*a, **k)
    grads["tris.v0"] = grads["tris.v0"] * 2.0
    return loss, grads
D.image_loss_and_grads = broken
"""),
    # a gradient where the reference has none: a leaf the step does not read
    "grads-stray": ("sphere1m-grads", STEP + """
def broken(*a, **k):
    loss, grads = real(*a, **k)
    grads["materials.specular"] = grads["materials.specular"] + 1e-3
    return loss, grads
D.image_loss_and_grads = broken
"""),
    # a step that leaves everything as it was: no gradient at all
    "grads-unchanged": ("sphere1m-grads", STEP + """
def broken(*a, **k):
    loss, grads = real(*a, **k)
    return loss, {n: g * 0 for n, g in grads.items()}
D.image_loss_and_grads = broken
"""),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(fault, checkout):
    cell, prelude = FAULTS[fault]
    r = run_cell(checkout, cell, seconds=2.0, prelude=prelude)["result"]
    assert r["correct"] is False, r["checks"]


@pytest.mark.parametrize("cell", ["sphere1m-walk", "sphere1m-grads"])
def test_the_control_fails_the_limits(cell, tmp_path):
    root = make_checkout(tmp_path / "c")
    bench = cells.Benchmark(root / "BENCHMARK.json")
    w = bench.cell(cell)
    traffic = json.loads((root / "rtbench" / "traffic" / f"{w['traffic']}.json").read_text())
    run = loops.Run(cell=cell, config=bench.config(w), traffic=traffic, seed=2**31 + 11,
                    seconds=0.0, trace=False, device=torch.device("cpu"), root=cells.HERE,
                    t0=0.0)
    numbers = cells.loop(cells.HERE, traffic["loop"]).control(run)
    ok, shown = check.verdict(numbers, check.limits(root / "rtbench", cell))
    assert not ok, shown


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["museum160k-walk"])
def test_the_control_fails_the_limits_at_the_cells_size(cell, card):
    bench = cells.Benchmark(cells.HERE.parent / "BENCHMARK.json")
    w = bench.cell(cell)
    traffic = cells.traffic(cells.HERE, w["traffic"])
    run = loops.Run(cell=cell, config=bench.config(w), traffic=traffic, seed=2**31 + 12,
                    seconds=0.0, trace=False, device=card, root=cells.HERE, t0=0.0)
    numbers = cells.loop(cells.HERE, traffic["loop"]).control(run)
    ok, shown = check.verdict(numbers, check.limits(cells.HERE, cell))
    assert not ok, shown
