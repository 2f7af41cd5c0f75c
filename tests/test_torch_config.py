"""The port's own configuration and chemistry against the JAX package's, and
its import boundary.

* ``bio_diffusion_torch.config``'s ``build_experiment(load_config(...))``
  equals the JAX package's under ``to_dict`` for the training config (QM9
  experiment, synthetic data) and the serving config, each also with the
  tiny overrides of the parity tests.
* ``bio_diffusion_torch.chem``'s ``batch_molecular_stability`` equals the JAX
  package's on seeded random molecules.
* No module of the port and not ``chip_smoke.py`` has an import statement
  that names ``bio_diffusion_tpu`` (an AST scan of every file).
"""

import ast
import os
from pathlib import Path

import numpy as np
import pytest

from bio_diffusion_torch.chem.stability import batch_molecular_stability
from bio_diffusion_torch.config import build, loader, schema
from bio_diffusion_torch.data.dataset_info import get_dataset_info
from bio_diffusion_tpu.chem.stability import batch_molecular_stability as jax_batch_molecular_stability
from bio_diffusion_tpu.config import build as jax_build
from bio_diffusion_tpu.config import loader as jax_loader
from bio_diffusion_tpu.config import schema as jax_schema
from test_torch_common import TINY_OVERRIDES

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("name,overrides", [
    ("train", ["experiment=qm9_mol_gen_ddpm", "datamodule.dataloader_cfg.dataset=synthetic"]),
    ("train", ["experiment=qm9_mol_gen_ddpm"] + TINY_OVERRIDES + ["trainer.precision=bf16"]),
    ("serve", []),
    ("serve", TINY_OVERRIDES + ["precision=fp32"]),
])
def test_build_experiment_matches_jax(name, overrides):
    assert loader.default_config_dir() == jax_loader.default_config_dir()
    ours = build.build_experiment(loader.load_config(loader.default_config_dir(), name, overrides))
    ref = jax_build.build_experiment(jax_loader.load_config(jax_loader.default_config_dir(), name, overrides))
    assert schema.to_dict(ours) == jax_schema.to_dict(ref)
    assert type(ours.model_cfg).__module__ == "bio_diffusion_torch.config.schema"
    assert ours.seed == ref.seed


def test_safe_arith_matches_jax():
    for text in ("50 // 8", "3 * 4 - 1", "1e-4 / 2", "-7 + 2"):
        assert build.safe_arith(text) == jax_build.safe_arith(text)
    with pytest.raises(ValueError):
        build.safe_arith("__import__('os')")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_batch_molecular_stability_matches_jax(seed):
    rng = np.random.default_rng(seed)
    b, n = 16, 9
    info = get_dataset_info("QM9", False)
    mask = (np.arange(n)[None, :] < rng.integers(2, n + 1, size=(b, 1))).astype(np.float32)
    # atoms ~1-1.5 A apart, so bonds of every order occur
    positions = (rng.normal(size=(b, n, 3)) * 1.1).astype(np.float32) * mask[..., None]
    atom_types = rng.integers(0, len(info["atom_decoder"]), size=(b, n))
    ours = batch_molecular_stability(positions, atom_types, mask, info)
    ref = jax_batch_molecular_stability(positions, atom_types, mask, info)
    for a, r in zip(ours, ref):
        np.testing.assert_array_equal(a, r)
    assert ours[1].sum() > 0  # some atoms are stable


def _port_sources():
    files = sorted((REPO / "bio_diffusion_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 20
    return files


def test_port_imports_nothing_of_the_jax_package():
    offenders = []
    for path in _port_sources():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            offenders += [f"{os.path.relpath(path, REPO)}:{node.lineno} {m}" for m in names
                          if m.split(".")[0] in ("bio_diffusion_tpu", "jax", "flax", "optax")]
    assert not offenders, offenders
