"""Set-up, a few frames and steps of each traffic mix, through the
program's plain versions on the CPU at 64x48, up to the printed line's
keys; and the refusal without a card."""

from __future__ import annotations

import os
import subprocess
import sys

from rtbench.tests.conftest import REPO, run_cell

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def test_walk_frames_on_the_cpu(checkout):
    out = run_cell(checkout, "sphere1m-walk", seconds=2.0)
    r = out["result"]
    assert [k for k in r if k in KEYS] == KEYS
    assert list(r)[-1] == "checks"
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 3
    assert set(r["metrics"]) == {"frame_ms", "setup_s"}
    assert set(r["checks"]) == {"pixels_off", "picks_off"}
    assert out["forbidden"] == []


def test_walk_traced_on_the_cpu(checkout):
    r = run_cell(checkout, "sphere1m-walk", seconds=5.0, trace=1)["result"]
    assert r["correct"] is True
    # no device trace on the CPU: the host spans only, and no share of a
    # roofline read from nothing
    assert "engine_host_ms.walk" in r["metrics"]
    assert "frame_roofline.walk" not in r["metrics"]
    assert "busy_s" in r["device"] and "window_s" in r["device"] and "breakdown" in r


def test_grads_steps_on_the_cpu(checkout):
    r = run_cell(checkout, "sphere1m-grads", seconds=1.0)["result"]
    assert r["failed"] == 0 and r["attempted"] >= 1
    assert set(r["metrics"]) == {"step_ms", "setup_s"}
    assert set(r["checks"]) == {"loss_gap", "grad_gap", "stray_grad"}
    # at 64 columns a column of pixels on an edge that the program's
    # intersection misses (PERF.md) weighs 30 times what it does at 1920,
    # and one pixel a triangle's gradient: the numbers are held to bounds
    # of this size, not to the cell's limits
    c = {k: v["value"] for k, v in r["checks"].items()}
    assert c["loss_gap"] < 5e-3 and c["grad_gap"] < 0.25 and c["stray_grad"] == 0.0


def test_no_card_no_result():
    """Without a card the run exits 2 and prints nothing on stdout."""
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run([sys.executable, "-m", "rtbench.run", "--workload", "museum160k-walk",
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=REPO, capture_output=True, text=True, timeout=120, env=env)
    assert proc.returncode == 2
    assert proc.stdout.strip() == ""
