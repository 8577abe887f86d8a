"""Nothing the benchmark imports is JAX, jaxlib, flax or the JAX package
(each module's top-level name compared whole: the port's name begins with
the JAX package's), and the plain reference imports nothing of the port."""

from __future__ import annotations

import ast
import os
import subprocess
import sys

import pytest

from benchmark import harness
from benchmark.run import FORBIDDEN, forbidden_modules

SOURCES = sorted(p for p in harness.BENCH_DIR.rglob("*.py") if "__pycache__" not in p.parts)
PORT = "weaklysuperviseddl_tpu_torch"


def _imports(path) -> set[str]:
    """Top-level names of every module a file imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(harness.ROOT)))
def test_no_jax_import(path):
    assert not _imports(path) & set(FORBIDDEN)


@pytest.mark.parametrize("path", sorted((harness.BENCH_DIR / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert PORT not in _imports(path)


def test_forbidden_names_compare_whole():
    assert forbidden_modules([PORT, f"{PORT}.ops", "numpy"]) == []
    assert forbidden_modules(["jax.numpy", "flax", "weaklysuperviseddl_tpu.ops"]) == [
        "flax", "jax", "weaklysuperviseddl_tpu"]


def test_loading_every_part_loads_no_jax():
    """The harness, every driver and every reader, with the port's modules
    they reach, in a fresh process."""
    code = (
        "import sys; from benchmark import harness, counts, inputs, readings, limits\n"
        "import benchmark.reference.models, benchmark.reference.train\n"
        "import benchmark.reference.serve, benchmark.reference.cam\n"
        "for p in (harness.BENCH_DIR / 'drivers').glob('*.py'): harness.driver(p.stem)\n"
        "for p in (harness.BENCH_DIR / 'metrics').glob('*.py'): harness.reader(p.stem)\n"
        "import weaklysuperviseddl_tpu_torch.train.alternating\n"
        "import weaklysuperviseddl_tpu_torch.pipelines.serve\n"
        "import weaklysuperviseddl_tpu_torch.masks.pseudo\n"
        "from benchmark.run import forbidden_modules\n"
        "print(forbidden_modules())\n")
    env = dict(os.environ, **harness.environment())
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
