"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program either.  Modules are compared by
their top-level name (the part before the first dot) as a whole word: the
program's name begins with the JAX package's."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
JAX_SIDE = {"jax", "jaxlib", "flax", "tiny_renderer_tpu"}
PROGRAM = "tiny_renderer_tpu_torch"


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")), ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_side_import(path):
    assert not top_level_imports(path) & JAX_SIDE


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_only_torch_and_numpy(path):
    assert top_level_imports(path) <= {"__future__", "numpy", "torch"}


def test_whole_names():
    """The program's name is allowed where the JAX package's is not."""
    assert PROGRAM.split(".")[0] not in JAX_SIDE
    assert "tiny_renderer_tpu.ops".split(".")[0] in JAX_SIDE


def test_a_run_loads_no_jax_side_module():
    """A whole run (on the CPU, small) loads none of them: the harness
    checks sys.modules once the window has closed, and the run succeeds."""
    out = subprocess.run([sys.executable, str(BENCH / "tests" / "drive_run.py"), "diablo-shadow.interactive",
                          "--seconds", "0.3"], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]


def test_harness_refuses_a_jax_side_module(monkeypatch):
    from benchmark import harness

    monkeypatch.setitem(sys.modules, "tiny_renderer_tpu.fake", object())
    assert harness._forbidden_modules() == ["tiny_renderer_tpu"]
    monkeypatch.delitem(sys.modules, "tiny_renderer_tpu.fake")
    monkeypatch.setitem(sys.modules, "tiny_renderer_tpu_torch_like", object())
    assert "tiny_renderer_tpu" not in harness._forbidden_modules()
