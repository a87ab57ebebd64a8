"""The benchmark twin (``python -m clraytracer_tpu_torch.bench``) and
``cli bench`` on the CPU at 32x24: one JSON row with ``metric``, ``value``
and ``unit`` (the host clock, the device named), the ``--grads`` row, the
matrix written only where ``--out`` points (the repository's
BENCH_MATRIX.json byte-equal after it), an error row for ``museum``
without its assets, and the refusal to run without a card unless asked
for the CPU."""

import json
import os
from pathlib import Path

import pytest
import torch

from clraytracer_tpu_torch import bench, cli
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parent.parent
SMALL = ["--device", "cpu", "--width", "32", "--height", "24", "--iters", "1"]


def _rows(out: str) -> list[dict]:
    return [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]


@pytest.mark.parametrize("extra", [[], ["--grads"], ["--scene", "two", "--tracer", "wavefront"]],
                         ids=["frame", "grads", "two-wavefront"])
def test_twin_prints_one_row(extra, capsys, tmp_path):
    out = tmp_path / "row.json"
    assert bench.main(SMALL + extra + ["--out", str(out)]) == 0
    rows = _rows(capsys.readouterr().out)
    assert len(rows) == 1
    row = rows[0]
    assert row["unit"] == "Mrays/s" and row["value"] > 0 and row["metric"]
    assert row["device"] == "cpu" and row["clock"] == "host" and row["card"] is None
    assert "vs_baseline" not in row
    assert row["ms_min"] <= row["ms"] <= row["ms_max"]
    assert row["value"] == pytest.approx(32 * 24 * 2 / (row["ms"] * 1e-3) / 1e6)
    assert ("fwd+bwd" in row["metric"]) == ("--grads" in extra)
    assert json.loads(out.read_text()) == row


def test_cli_bench_runs_the_twin(capsys):
    assert cli.main(["bench", "--device", "cpu", "--width", "32", "--height", "24",
                     "--scene", "two"]) == 0
    rows = _rows(capsys.readouterr().out)
    assert len(rows) == 1 and rows[0]["iters"] == 8
    assert rows[0]["metric"].startswith("fwd rays/s, 32x24x2bounce two, tracer=best")


def test_matrix_writes_only_where_out_points(monkeypatch, capsys, tmp_path):
    """Two of the matrix's rows (each in its own process): flagship, and
    museum without ``$CLRT_REFERENCE_ASSETS``, an error row."""
    monkeypatch.setattr(bench, "MATRIX_ROWS", (bench.MATRIX_ROWS[0], bench.MATRIX_ROWS[1]))
    monkeypatch.delenv("CLRT_REFERENCE_ASSETS", raising=False)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the rows' processes beside the workers
    monkeypatch.chdir(tmp_path)
    before = (ROOT / "BENCH_MATRIX.json").read_bytes()
    out = tmp_path / "matrix.json"
    assert bench.main(SMALL + ["--matrix", "--out", str(out)]) == 0
    rows = _rows(capsys.readouterr().out)
    assert json.loads(out.read_text()) == rows
    assert [r.get("row", r["metric"]) for r in rows] == ["flagship", "museum"]
    assert rows[0]["unit"] == "Mrays/s" and rows[0]["device"] == "cpu"
    assert "error" in rows[1] and "reference assets" in rows[1]["error"]
    assert (ROOT / "BENCH_MATRIX.json").read_bytes() == before
    assert sorted(os.listdir(tmp_path)) == ["matrix.json"]


def test_twin_needs_a_card_or_the_cpu_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is the card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.main(["--width", "32", "--height", "24"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.main(["--matrix", "--width", "32", "--height", "24"])
