"""Synthetic molecules with the QM9 schema, for tests and offline training.

Copy of ``bio_diffusion_tpu/data/synthetic.py::synthetic_qm9_like``: the same
seed gives byte-identical arrays.  Random-walk chains with ~1.4 A steps, QM9
species, sizes 4..29, padded to 29 atoms: QM9's shape, not its chemistry.
``write_qm9_layout`` writes such molecules as the processed QM9 files the
loader (``data/qm9.py``) reads, and ``write_geom_layout`` writes chains with
GEOM-Drugs' sizes and atom types as the conformer files the GEOM loader
(``data/geom.py``) reads, for rehearsals of the data path.
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence

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


# a fixed per-element (H, C, N, O, F) reference table for the *_thermo
# columns of written files (values in the GDB9 atomref's units and range)
_FIXTURE_THERMO = {
    "zpve": {1: 0.0, 6: 0.0, 7: 0.0, 8: 0.0, 9: 0.0},
    "U0": {1: -0.500273, 6: -37.846772, 7: -54.583861, 8: -75.064579, 9: -99.718730},
    "U": {1: -0.498857, 6: -37.845355, 7: -54.582445, 8: -75.063162, 9: -99.717314},
    "H": {1: -0.497912, 6: -37.844411, 7: -54.581501, 8: -75.062219, 9: -99.716370},
    "G": {1: -0.510927, 6: -37.861317, 7: -54.598897, 8: -75.079532, 9: -99.733544},
    "Cv": {1: 2.981, 6: 2.981, 7: 2.981, 8: 2.981, 9: 2.981},
}


def write_qm9_layout(data_dir: str, counts: Sequence[int] = (1024, 256, 256), seed: int = 0) -> str:
    """Write ``<data_dir>/QM9/{train,valid,test}.npz`` in the processed EDM
    QM9 layout (``num_atoms``, ``charges``, ``positions``, ``index``, the 15
    QM9 properties, ``omega1`` and the six ``*_thermo`` columns; hydrogens
    kept, padded to 29 atoms) from ``synthetic_qm9_like`` molecules drawn
    from ``seed``; returns the QM9 directory."""
    from bio_diffusion_torch.data.qm9 import QM9_PROPERTY_NAMES, add_thermo_targets

    qm9_dir = os.path.join(data_dir, "QM9")
    os.makedirs(qm9_dir, exist_ok=True)
    for i, (split, n) in enumerate(zip(("train", "valid", "test"), counts)):
        d = synthetic_qm9_like(n, seed=seed + i).data
        rng = np.random.default_rng(seed + 100 + i)
        data = {"num_atoms": d["num_atoms"], "charges": d["charges"], "positions": d["positions"],
                "index": np.arange(1, n + 1, dtype=np.int64)}
        for name in QM9_PROPERTY_NAMES[1:] + ["omega1"]:
            data[name] = d[name] if name in d else rng.normal(size=n)
        np.savez_compressed(os.path.join(qm9_dir, f"{split}.npz"), **add_thermo_targets(data, _FIXTURE_THERMO))
    return qm9_dir


def geom_like_conformers(sizes: Sequence[int], rng: np.random.Generator) -> List[np.ndarray]:
    """One ``[n, 4]`` (Z, x, y, z) chain a size: atom types drawn from
    GEOM-Drugs' atom-type frequencies (with hydrogens), ~1.4 A random-walk
    steps, centred."""
    from bio_diffusion_torch.data.dataset_info import GEOM_WITH_H

    counts = GEOM_WITH_H["atom_types"]
    p = np.array([counts[k] for k in range(len(GEOM_WITH_H["atomic_nb"]))], dtype=np.float64)
    atomic_nb = np.asarray(GEOM_WITH_H["atomic_nb"], dtype=np.float64)
    out = []
    for n in sizes:
        steps = rng.normal(size=(int(n), 3))
        steps /= np.linalg.norm(steps, axis=-1, keepdims=True)
        pos = np.cumsum(steps * 1.4, axis=0)
        z = atomic_nb[rng.choice(len(p), size=int(n), p=p / p.sum())]
        out.append(np.concatenate([z[:, None], pos - pos.mean(axis=0)], axis=1))
    return out


def write_geom_layout(data_dir: str, num_conformers: int = 2048, seed: int = 0) -> str:
    """Write ``<data_dir>/GEOM/GEOM_drugs_30.npy`` (``[total_atoms, 5]``:
    mol_id, Z, x, y, z), ``GEOM_drugs_n_30.npy`` (atoms a conformer) and
    ``GEOM_drugs_smiles.txt`` (one line a molecule), the layout
    ``data.geom.extract_conformers`` writes, from ``seed``: sizes drawn from
    GEOM-Drugs' size histogram (3..181 atoms), 1-3 conformers a molecule
    (the same atoms, positions jittered by 0.1 A); returns the GEOM
    directory.  No permutation file is written: the loader makes it."""
    from bio_diffusion_torch.data.dataset_info import GEOM_WITH_H

    rng = np.random.default_rng(seed)
    hist = GEOM_WITH_H["n_nodes"]
    sizes = np.array(sorted(hist))
    p = np.array([hist[k] for k in sizes], dtype=np.float64)
    decoder = GEOM_WITH_H["atom_decoder"]
    nb = list(GEOM_WITH_H["atomic_nb"])
    rows, counts, smiles = [], [], []
    while len(counts) < num_conformers:
        (mol,) = geom_like_conformers([rng.choice(sizes, p=p / p.sum())], rng)
        smiles.append("".join(f"[{decoder[nb.index(int(z))]}]" for z in mol[:, 0] if z != 1))
        for _ in range(min(int(rng.integers(1, 4)), num_conformers - len(counts))):
            conf = mol.copy()
            conf[:, 1:] += rng.normal(scale=0.1, size=conf[:, 1:].shape)
            rows.append(np.concatenate([np.full((len(conf), 1), float(len(counts))), conf], axis=1))
            counts.append(len(conf))
    geom_dir = os.path.join(data_dir, "GEOM")
    os.makedirs(geom_dir, exist_ok=True)
    np.save(os.path.join(geom_dir, "GEOM_drugs_30.npy"), np.vstack(rows))
    np.save(os.path.join(geom_dir, "GEOM_drugs_n_30.npy"), np.array(counts))
    with open(os.path.join(geom_dir, "GEOM_drugs_smiles.txt"), "w") as f:
        f.write("\n".join(smiles) + "\n")
    return geom_dir
