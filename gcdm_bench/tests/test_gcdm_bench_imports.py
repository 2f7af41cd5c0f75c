"""Nothing under the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program (top-level module names compared whole)."""

import ast
from pathlib import Path

import pytest

from gcdm_bench.harness import FORBIDDEN, ROOT

FILES = sorted(ROOT.rglob("*.py"))


def top_level_imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax(path):
    assert not set(top_level_imports(path)) & set(FORBIDDEN)


@pytest.mark.parametrize("path", sorted((ROOT / "reference").rglob("*.py")), ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    assert not set(top_level_imports(path)) & {"bio_diffusion_torch", "bio_diffusion_tpu", "gcdm_bench"}


def test_the_names_are_compared_whole():
    # the port's name begins with the JAX package's and is allowed
    assert "bio_diffusion_torch" not in FORBIDDEN and "bio_diffusion_tpu" in FORBIDDEN
