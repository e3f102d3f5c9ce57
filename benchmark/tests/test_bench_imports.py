"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program; names compare by their top-level
part whole, so jpegtpu_torch is not jpegtpu."""
from __future__ import annotations

import ast
import os
import subprocess
import sys

import pytest

from conftest import REPO

from benchmark.run import forbidden_modules


@pytest.mark.parametrize("names, bad", [
    (["jpegtpu_torch", "jpegtpu_torch.serving", "numpy"], []),
    (["jpegtpu", "jpegtpu_torch"], ["jpegtpu"]),
    (["jpegtpu.pipeline"], ["jpegtpu"]),
    (["jax._src.core", "jaxlib", "flax.linen", "jaxtyping"],
     ["flax", "jax", "jaxlib"]),
])
def test_forbidden_names_by_top_level(names, bad):
    assert forbidden_modules(names) == bad


def _loaded_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\n"
         "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=REPO, capture_output=True, text=True, check=True,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    return set(out.stdout.split())


def test_the_harness_loads_neither_jax_nor_jpegtpu():
    loaded = _loaded_after(
        "from benchmark.manifest import Bench\n"
        "import benchmark.run, benchmark.check, benchmark.trace\n"
        "b = Bench()\n"
        "for w in b.manifest['workloads']:\n"
        "    c = b.config(w['config']); b.reference(c['reference'])\n"
        "    b.driver(b.traffic(w['traffic'])['driver'])\n"
        "    [b.reader(m['name']) for t in (0, 1) for m in b.metrics(w['name'], t)]\n")
    assert "jpegtpu_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "jpegtpu"}


def test_the_reference_loads_nothing_of_the_program():
    loaded = _loaded_after("import benchmark.reference.encoder, "
                           "benchmark.reference.compare")
    assert not loaded & {"jax", "jaxlib", "flax", "jpegtpu", "jpegtpu_torch"}
    ref_dir = os.path.join(REPO, "benchmark", "reference")
    for name in os.listdir(ref_dir):
        if not name.endswith(".py"):
            continue
        tree = ast.parse(open(os.path.join(ref_dir, name)).read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                tops = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                tops = [(node.module or "").split(".")[0]]
            else:
                continue
            assert not set(tops) & {"jpegtpu", "jpegtpu_torch", "jax"}, name
