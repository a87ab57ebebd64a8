"""No module of the benchmark loads JAX or the JAX package, compared by
whole top-level names (the port's name begins with the JAX package's),
and the plain reference reaches nothing of the program."""

from __future__ import annotations

import ast
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "clraytracer_tpu"}


def _imports(path: Path) -> list[str]:
    out = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.append(node.module)
    return out


def test_no_module_loads_jax_or_the_jax_package():
    files = sorted(ROOT.rglob("*.py"))
    assert len(files) > 20
    for f in files:
        for name in _imports(f):
            assert name.split(".")[0] not in FORBIDDEN, (f, name)


def test_the_reference_reaches_nothing_of_the_program():
    """The reference's imports, followed through the benchmark's own
    modules, never reach the program's package."""
    seen, todo = set(), [p for p in (ROOT / "reference").glob("*.py")]
    while todo:
        f = todo.pop()
        if f in seen:
            continue
        seen.add(f)
        for name in _imports(f):
            top = name.split(".")[0]
            assert top != "clraytracer_tpu_torch" and top not in FORBIDDEN, (f, name)
            if top == "rtbench":
                p = ROOT.parent / (name.replace(".", "/") + ".py")
                todo.append(p if p.exists() else ROOT.parent / name.replace(".", "/") /
                            "__init__.py")
    assert any("scenes" not in str(p) for p in seen)
