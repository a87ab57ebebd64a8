"""The port's two viewers on the CPU: the live viewer as a subprocess with
``--device cpu`` at 64x48 on a free port of its own, through every
endpoint tests/test_live_viewer.py exercises (frames, live material edit,
pick, fly, the resource panel, thumbnails, the file browser, scene
hot-swap) and the same page; and ``tools.viewer`` writing a 3-frame
turntable at 32x24."""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import pytest
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parent.parent
PNG = b"\x89PNG\r\n\x1a\n"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def get():
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "clraytracer_tpu_torch.tools.live_viewer", "--scene", "two",
         "--width", "64", "--height", "48", "--port", str(port), "--device", "cpu"],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
    )

    url = f"http://127.0.0.1:{port}"

    def _get(path: str, timeout: float = 120.0) -> bytes:
        with urllib.request.urlopen(url + path, timeout=timeout) as r:
            return r.read()

    _get.url = url

    try:
        deadline = time.time() + 120
        while True:
            try:
                _get("/", timeout=5)
                break
            except OSError:
                if proc.poll() is not None:
                    raise RuntimeError(f"viewer died:\n{proc.stdout.read().decode(errors='replace')}")
                if time.time() > deadline:
                    raise RuntimeError("viewer did not come up")
                time.sleep(0.5)
        yield _get
    finally:
        proc.terminate()
        proc.wait(timeout=10)
        proc.stdout.close()


def test_viewer_endpoints(get):
    """tests/test_live_viewer.py::test_viewer_endpoints on the port."""
    assert b"clraytracer_tpu" in get("/")
    frame = get("/frame?mx=0&my=0&r=0&u=0&f=0")
    assert frame[:8] == PNG
    mats = json.loads(get("/materials"))
    assert len(mats) >= 3 and all(m.startswith("#") for m in mats)
    get("/material?i=1&c=%230000ff")
    assert json.loads(get("/materials"))[1] == "#0000ff"
    hit = json.loads(get("/pick?x=24&y=26"))
    assert hit["hit"] is True and hit["instance"] == 0
    assert hit["color"][0] <= 0.25  # red gone after the blue edit
    f2 = get("/frame?mx=0&my=0&r=0&u=0&f=1")
    assert f2[:8] == PNG and f2 != frame
    json.loads(get("/sun?v=-1.2"))


def test_viewer_resource_panel(get):
    """tests/test_live_viewer.py::test_viewer_resource_panel on the port."""
    res = json.loads(get("/resources"))
    assert res["summary"]["instances"] == 2 and len(res["meshes"]) == 2
    assert res["meshes"][0]["tris"] > 0 and len(res["instances"]) == 2
    assert res["instances"][0]["position"][0] == pytest.approx(-2.0, abs=1e-3)
    assert len(res["textures"]) >= 3 and len(res["materials"]) >= 3
    assert get("/thumb?i=2")[:8] == PNG
    files = json.loads(get("/files"))
    assert "dir" in files and isinstance(files["dirs"], list)
    out = json.loads(get("/open?path=sphere", timeout=300))
    assert out["instances"] == 1
    assert json.loads(get("/resources"))["summary"]["instances"] == 1
    assert get("/frame?mx=0&my=0&r=0&u=0&f=0", timeout=300)[:8] == PNG
    assert "error" in json.loads(get("/open?path=no-such-scene"))
    assert json.loads(get("/open?path=two", timeout=300))["instances"] == 2


def test_frames_count_up(get):
    """X-Frame rises frame by frame, and the camera turns each one."""
    numbers, bodies = [], []
    for _ in range(3):
        with urllib.request.urlopen(get.url + "/frame?mx=5&my=0&r=0&u=0&f=0",
                                    timeout=120) as r:
            numbers.append(int(r.headers["X-Frame"]))
            bodies.append(r.read())
    assert numbers == sorted(numbers) and len(set(numbers)) == 3
    assert all(b[:8] == PNG for b in bodies) and len(set(bodies)) == 3


def test_page_is_the_jax_viewers_page():
    from clraytracer_tpu_torch.tools.live_viewer import _PAGE

    src = (ROOT / "tools" / "live_viewer.py").read_text()
    assert _PAGE in src
    assert "setTheme" in _PAGE and "ondrop" in _PAGE and "text/clrt-path" in _PAGE


def test_turntable_writes_frames(tmp_path, capsys):
    from clraytracer_tpu_torch.tools import viewer

    out = tmp_path / "turn"
    assert viewer.main(["--scene", "two", "--frames", "3", "--width", "32", "--height", "24",
                        "--device", "cpu", "-o", str(out)]) == 0
    names = sorted(os.listdir(out))
    assert names == ["frame_0000.png", "frame_0001.png", "frame_0002.png"]
    bodies = [(out / n).read_bytes() for n in names]
    assert all(b[:8] == PNG for b in bodies) and len(set(bodies)) == 3
    assert "3 frames in" in capsys.readouterr().out
