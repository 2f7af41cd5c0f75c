"""Synthetic molecules with the QM9 schema, for tests and offline training.

Copy of ``bio_diffusion_tpu/data/synthetic.py::synthetic_qm9_like``: the same
seed gives byte-identical arrays.  Random-walk chains with ~1.4 A steps, QM9
species, sizes 4..29, padded to 29 atoms: QM9's shape, not its chemistry.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from bio_diffusion_torch.data.batch import DenseDataset

QM9_SPECIES = np.array([1, 6, 7, 8, 9])


def synthetic_qm9_like(
    num_molecules: int = 256,
    max_nodes: int = 29,
    min_nodes: int = 4,
    seed: int = 0,
    include_properties: bool = True,
) -> DenseDataset:
    """A QM9-schema synthetic dataset with chain-like 3D geometry."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(min_nodes, max_nodes + 1, size=num_molecules)

    positions = np.zeros((num_molecules, max_nodes, 3), dtype=np.float64)
    charges = np.zeros((num_molecules, max_nodes), dtype=np.int64)
    for i, n in enumerate(sizes):
        # random-walk chain with ~1.4 A steps, slightly noised
        steps = rng.normal(size=(n, 3))
        steps /= np.linalg.norm(steps, axis=-1, keepdims=True)
        pos = np.cumsum(steps * 1.4, axis=0)
        pos = pos - pos.mean(axis=0)
        positions[i, :n] = pos + rng.normal(scale=0.05, size=pos.shape)
        charges[i, :n] = rng.choice(QM9_SPECIES, size=n, p=[0.5, 0.35, 0.06, 0.06, 0.03])

    data: Dict[str, np.ndarray] = {
        "num_atoms": sizes.astype(np.int64),
        "positions": positions,
        "charges": charges,
        "index": np.arange(num_molecules, dtype=np.int64),
    }
    if include_properties:
        # structure-correlated properties (like the real QM9 ones): a
        # property classifier trained on this data can genuinely learn, so
        # conditional-evaluation MAE is discriminating rather than noise
        n = sizes.astype(np.float64)
        com = positions.sum(1) / n[:, None]
        rg = np.sqrt(
            (((positions - com[:, None]) ** 2).sum(-1) * (charges > 0)).sum(1) / n
        )
        frac_heavy = (charges > 1).sum(1) / n
        data["alpha"] = n + 0.3 * rng.normal(size=num_molecules)  # grows with size
        data["Cv"] = 0.5 * n + 0.2 * rng.normal(size=num_molecules)
        data["mu"] = rg + 0.3 * rng.normal(size=num_molecules)
        data["homo"] = -5.0 - frac_heavy + 0.1 * rng.normal(size=num_molecules)
        data["lumo"] = 1.0 + 0.5 * frac_heavy + 0.1 * rng.normal(size=num_molecules)
        data["gap"] = data["lumo"] - data["homo"] + 0.05 * rng.normal(size=num_molecules)

    one_hot = (charges[..., None] == QM9_SPECIES[None, None, :]).astype(np.float32)
    data["one_hot"] = one_hot
    return DenseDataset(data, included_species=QM9_SPECIES)
