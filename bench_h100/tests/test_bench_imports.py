"""Nothing on the card's path imports JAX or the JAX package, and the
reference imports nothing of the measured program: by the sources'
imports, and by the modules a tiny run leaves loaded."""
from __future__ import annotations

import ast
import os
import subprocess
import sys

import pytest
from conftest import BENCH, ROOT

from harness.common import FORBIDDEN, forbidden_modules

SOURCES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


def imported(path) -> set[str]:
    """Top-level names of the modules ``path`` imports (absolute imports)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_in_the_harness(path):
    assert not imported(path) & set(FORBIDDEN)


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert imported(path) <= {"__future__", "contextlib", "functools", "math", "numpy",
                              "torch"}


def test_forbidden_names_compared_whole():
    assert forbidden_modules(["emrt_tpu_torch", "emrt_tpu_torch.models", "jaxtyping"]) == []
    assert forbidden_modules(["emrt_tpu.models", "jax.numpy", "flax", "jaxlib"]) == [
        "emrt_tpu", "flax", "jax", "jaxlib"]


def test_a_run_loads_no_jax(tiny):
    """A tiny CPU run in a fresh process leaves no JAX module loaded."""
    code = (f"import sys, time; sys.path[:0] = [{str(BENCH)!r}, {str(ROOT)!r}]\n"
            "from harness.common import Manifest, forbidden_modules\n"
            "from harness.runner import run_cell\n"
            f"run_cell('emrt_r50.slide_4x1024', 5, 0.1, False, 'cpu', time.perf_counter(), "
            f"Manifest({str(tiny.root)!r}))\n"
            "print('FORBIDDEN', forbidden_modules())\n")
    env = dict(os.environ, OMP_NUM_THREADS="2")   # beside the other test workers
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, env=env, cwd=str(tiny.root))
    assert out.returncode == 0, out.stderr[-2000:]
    assert "FORBIDDEN []" in out.stdout
