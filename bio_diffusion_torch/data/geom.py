"""GEOM-Drugs from files on disk: msgpack extraction, fixed splits, dense loading.

Copy of ``bio_diffusion_tpu/data/geom.py`` (the port imports nothing of the
JAX package), the counterpart of the reference's build_geom_dataset.py:

  * ``extract_conformers``: msgpack crude file -> up to 30 lowest-energy
    conformers a molecule, stacked ``[total_atoms, 5]`` (mol_id, Z, x, y, z)
    + SMILES list + per-conformer atom counts
  * ``load_split_data``: fixed stored permutation (``GEOM_permutation.npy``,
    written from ``RandomState(0)`` when missing), 10/10/80 valid/test/train
  * ``load_geom_datasets``: dense ``[M, Nmax]`` splits with the GEOM one-hot;
    molecules have 3..181 atoms, and the Trainer pads each batch to its
    bucket (``DataloaderConfig.bucket_sizes``).

The port never downloads: without the conformer file ``load_geom_datasets``
raises ``FileNotFoundError``.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from bio_diffusion_torch.data.batch import DenseDataset
from bio_diffusion_torch.data.dataset_info import GEOM_NO_H, GEOM_WITH_H
from bio_diffusion_torch.utils.logging import get_logger

log = get_logger(__name__)


def extract_conformers(
    data_dir: str,
    data_file: str = "drugs_crude.msgpack",
    conformations: int = 30,
    remove_h: bool = False,
) -> None:
    """msgpack -> GEOM_drugs_{30}.npy / GEOM_drugs_smiles.txt / GEOM_drugs_n_{30}.npy."""
    import msgpack

    drugs_file = os.path.join(data_dir, data_file)
    save_file = f"GEOM_drugs_{'no_h_' if remove_h else ''}{conformations}"
    smiles_list_file = "GEOM_drugs_smiles.txt"
    number_atoms_file = f"GEOM_drugs_n_{'no_h_' if remove_h else ''}{conformations}"

    all_smiles, all_number_atoms, dataset_conformers = [], [], []
    mol_id = 0
    with open(drugs_file, "rb") as f:
        for i, drugs_1k in enumerate(msgpack.Unpacker(f)):
            log.info(f"Unpacking chunk {i}...")
            for smiles, all_info in drugs_1k.items():
                all_smiles.append(smiles)
                conformers = all_info["conformers"]
                energies = np.array([c["totalenergy"] for c in conformers])
                for idx in np.argsort(energies)[:conformations]:
                    coords = np.array(conformers[idx]["xyz"]).astype(float)  # n x 4 (Z, x, y, z)
                    if remove_h:
                        coords = coords[coords[:, 0] != 1.0]
                    n = coords.shape[0]
                    all_number_atoms.append(n)
                    mol_id_arr = mol_id * np.ones((n, 1), dtype=float)
                    dataset_conformers.append(np.hstack((mol_id_arr, coords)))
                    mol_id += 1

    dataset = np.vstack(dataset_conformers)
    np.save(os.path.join(data_dir, save_file), dataset)
    with open(os.path.join(data_dir, smiles_list_file), "w") as f:
        f.write("\n".join(all_smiles) + "\n")
    np.save(os.path.join(data_dir, number_atoms_file), np.array(all_number_atoms))
    log.info(f"Saved {mol_id} conformers ({dataset.shape[0]} atoms)")


def load_split_data(
    conformation_file: str,
    val_proportion: float = 0.1,
    test_proportion: float = 0.1,
    filter_size: Optional[int] = None,
) -> Dict[str, List[np.ndarray]]:
    """Split the stacked conformer array by the stored fixed permutation."""
    base_path = os.path.dirname(os.path.abspath(conformation_file))
    all_data = np.load(conformation_file)  # [total_atoms, 5]
    mol_id = all_data[:, 0].astype(int)
    conformers = all_data[:, 1:]
    split_indices = np.nonzero(mol_id[:-1] - mol_id[1:])[0] + 1
    data_list = np.split(conformers, split_indices)

    if filter_size is not None:
        data_list = [m for m in data_list if m.shape[0] <= filter_size]
        assert len(data_list) > 0, "No molecules left after size filter."

    perm_path = os.path.join(base_path, "GEOM_permutation.npy")
    if os.path.exists(perm_path):
        perm = np.load(perm_path)
    else:
        # first-time processing: create and keep the permutation (the
        # reference ships a fixed one; this one is frozen the same way)
        log.warning("GEOM_permutation.npy not found — generating and saving a fixed permutation")
        perm = np.random.RandomState(0).permutation(len(data_list)).astype("int32")
        np.save(perm_path, perm)
    data_list = [data_list[i] for i in perm]

    num_mol = len(data_list)
    val_index = int(num_mol * val_proportion)
    test_index = val_index + int(num_mol * test_proportion)
    return {
        "valid": data_list[:val_index],
        "test": data_list[val_index:test_index],
        "train": data_list[test_index:],
    }


def _to_dense(data_list: List[np.ndarray], remove_h: bool) -> DenseDataset:
    """Ragged conformers -> padded DenseDataset with the GEOM one-hot
    (``charges`` holds the atomic numbers)."""
    info = GEOM_NO_H if remove_h else GEOM_WITH_H
    atomic_nb = np.asarray(info["atomic_nb"])
    sizes = np.array([len(m) for m in data_list])
    max_n = int(sizes.max()) if len(sizes) else 0
    m = len(data_list)
    positions = np.zeros((m, max_n, 3), dtype=np.float32)
    charges = np.zeros((m, max_n), dtype=np.int64)
    for i, mol in enumerate(data_list):
        n = len(mol)
        charges[i, :n] = mol[:, 0].astype(np.int64)
        positions[i, :n] = mol[:, 1:4]
    one_hot = (charges[..., None] == atomic_nb[None, None, :]).astype(np.float32)
    data = {
        "num_atoms": sizes.astype(np.int64),
        "positions": positions,
        "charges": charges,
        "one_hot": one_hot,
        "index": np.arange(m, dtype=np.int64),
    }
    return DenseDataset(data, included_species=atomic_nb)


def load_geom_datasets(
    data_dir: str,
    conformations: int = 30,
    remove_h: bool = False,
    filter_size: Optional[int] = None,
    val_proportion: float = 0.1,
    test_proportion: float = 0.1,
) -> Dict[str, DenseDataset]:
    """Train/valid/test ``DenseDataset``s from ``<data_dir>/GEOM``."""
    fname = f"GEOM_drugs_{'no_h_' if remove_h else ''}{conformations}.npy"
    conformation_file = os.path.join(data_dir, "GEOM", fname)
    if not os.path.exists(conformation_file):
        raise FileNotFoundError(
            f"{conformation_file} not found; the port does not download GEOM-Drugs. Place the "
            "crude msgpack (drugs_crude.msgpack) under <data_dir>/GEOM and run "
            "bio_diffusion_torch.data.geom.extract_conformers on it first (see the reference "
            "README 'GEOM-Drugs').")
    splits = load_split_data(conformation_file, val_proportion, test_proportion, filter_size)
    return {k: _to_dense(v, remove_h) for k, v in splits.items()}
