"""Fixtures of the benchmark's CPU tests: a copy of the benchmark in a
temporary checkout, cut to sizes the CPU's plain versions hold, and a run
of one of its cells in a process of its own."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]

#: sizes the CPU's plain versions hold: a 528-triangle sphere at 64x48
TINY = {
    "sphere1m": {"n_lat": 12, "width": 64, "height": 48},
    "walk": {"check_pixels": 512, "check_picks": 4, "watchdog_ms": 1e9, "pick_every": 2,
             "trace_from": 1, "trace_frames": 3},
    "grads": {"trace_from": 1, "trace_steps": 2},
}


#: the sphere's cells, which PERF.md holds out of BENCHMARK.json (the
#: program's crack on exact edges, the walk's host-bound spread), added to a
#: test checkout so that their loops keep running at the sizes above, with
#: limits that sound runs at those sizes meet and the planted faults fail
HELD = {
    "configs": [{"name": "sphere1m", "source": "https://github.com/benanil/CLRayTracer",
                 "file": "rtbench/configs/sphere1m.json", "reduced": [], "why": "a test"}],
    "workloads": [{"name": "sphere1m-walk", "config": "sphere1m", "traffic": "walk", "chips": 1,
                   "why": "a test"},
                  {"name": "sphere1m-grads", "config": "sphere1m", "traffic": "grads",
                   "chips": 1, "why": "a test"}],
    "end_to_end": [{"name": "step_ms", "unit": "ms", "better": "lower", "bound": 0.05,
                    "source": "host_clock", "workloads": ["sphere1m-grads"]}],
    "per_layer": [{"name": n, "unit": u, "better": "lower", "source": "device_trace",
                   "layer": layer, "moves": "step_ms", "workloads": ["sphere1m-grads"]}
                  for n, u, layer in (("fwd_device_ms.grads", "ms", "differentiable recompute"),
                                      ("bwd_device_ms.grads", "ms", "autograd backward"),
                                      ("launches.grads", "count", "autograd backward"),
                                      ("idle_share.grads", "%", "device"))],
    "limits": {"sphere1m-walk": {"pixels_off": 0.004, "picks_off": 0.05},
               "sphere1m-grads": {"loss_gap": 5e-3, "grad_gap": 0.1, "stray_grad": 0.0}},
}


def hold(root: Path) -> None:
    """The held-out cells' entries in ``root``'s BENCHMARK.json, the walk's
    metrics reported there too, and their limits."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        bench[key] += HELD[key]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] == "frame_ms" or m["name"].endswith(".walk"):
            m["workloads"].append("sphere1m-walk")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    for cell, lim in HELD["limits"].items():
        (root / "rtbench" / "limits" / f"{cell}.json").write_text(json.dumps({"limits": lim}))


def make_checkout(root: Path, sizes: dict = TINY) -> Path:
    """A checkout at ``root``: the benchmark's files with the held-out
    cells, its configurations and mixes cut to ``sizes``, the program beside
    them."""
    shutil.copytree(REPO / "rtbench", root / "rtbench",
                    ignore=shutil.ignore_patterns("__pycache__", "_work"))
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    hold(root)
    os.symlink(REPO / "clraytracer_tpu_torch", root / "clraytracer_tpu_torch")
    for sub in ("configs", "traffic"):
        for f in (root / "rtbench" / sub).glob("*.json"):
            data = json.loads(f.read_text())
            data.update(sizes.get(f.stem, {}))
            f.write_text(json.dumps(data))
    return root


@pytest.fixture
def checkout(tmp_path):
    return make_checkout(tmp_path / "checkout")


#: a run of a cell on the CPU through the plain versions: ``measure`` with
#: the device given, then the printed line's checks (``run.main`` refuses
#: the CPU)
RUN_CPU = """
import json, sys, time
t0 = time.perf_counter()
import torch
torch.set_num_threads(2)
from rtbench import run
{prelude}
args = run.parse(sys.argv[1:])
result = run.measure(args, device=torch.device("cpu"), t0=t0)
print(json.dumps({{"result": result, "forbidden": run.forbidden_modules()}}))
"""


def run_cell(root: Path, cell: str, seconds: float = 1.0, trace: int = 0, seed: int = 2**31 + 5,
             prelude: str = "") -> dict:
    code = RUN_CPU.format(prelude=prelude)
    proc = subprocess.run(
        [sys.executable, "-c", code, "--workload", cell, "--seed", str(seed), "--seconds",
         str(seconds), "--trace", str(trace)],
        cwd=root, capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": str(root)})
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture
def card():
    """The CUDA card, decided here and not at import: skips without one."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)
