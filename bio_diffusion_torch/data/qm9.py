"""QM9 (GDB9) from files on disk: xyz parsing, splits, thermo, loading.

Copy of ``bio_diffusion_tpu/data/qm9.py`` (the port imports nothing of the
JAX package), the numpy counterpart of the reference's EDM QM9 pipeline:

  * the GDB9 tarball + uncharacterized exclusion list + atomref thermo
  * fixed seed-0 permutation split: 100k train / 10% test / rest valid
  * per-split npz files with padded [M, 29] arrays
  * species one-hot from charges; thermo-target subtraction; eV conversion
  * QM9_first_half / QM9_second_half fixed seed-42 re-splits

The port never downloads.  ``prepare_qm9`` reads the processed
``<data_dir>/QM9/{train,valid,test}.npz``, or processes a GDB9 tarball with
its two text files already in ``<data_dir>/QM9``; with neither it raises.
"""

from __future__ import annotations

import os
import tarfile
from os.path import join
from typing import Dict, List, Optional

import numpy as np

from bio_diffusion_torch.chem.constants import CHARGE_DICT
from bio_diffusion_torch.data.batch import DenseDataset
from bio_diffusion_torch.utils.logging import get_logger

log = get_logger(__name__)

QM9_PROPERTY_NAMES = [
    "index", "A", "B", "C", "mu", "alpha", "homo", "lumo", "gap", "r2",
    "zpve", "U0", "U", "H", "G", "Cv",
]

# Hartree->eV conversions applied by the reference dataloader factory
# (edm/dataset.py:48-54)
QM9_TO_EV = {
    "U0": 27.2114, "U": 27.2114, "G": 27.2114, "H": 27.2114,
    "zpve": 27211.4, "gap": 27.2114, "homo": 27.2114, "lumo": 27.2114,
}

THERMO_TARGETS = ["zpve", "U0", "U", "H", "G", "Cv"]

NUM_GDB9 = 133885
NUM_EXCLUDED = 3054
NUM_TRAIN = 100000

# the raw GDB9 files, as the reference's download names them
GDB9_TAR = "dsgdb9nsd.xyz.tar.bz2"
GDB9_EXCLUDED = "uncharacterized.txt"
GDB9_THERMO = "atomref.txt"


def parse_xyz_gdb9(lines: List[str]) -> Dict[str, np.ndarray]:
    """Parse one GDB9 xyz record (reference process.py:process_xyz_gdb9)."""
    num_atoms = int(lines[0])
    mol_props = lines[1].split()
    mol_xyz = lines[2: num_atoms + 2]
    mol_freq = lines[num_atoms + 2]

    charges, positions = [], []
    for line in mol_xyz:
        atom, px, py, pz, _ = line.replace("*^", "e").split()
        charges.append(CHARGE_DICT[atom])
        positions.append([float(px), float(py), float(pz)])

    out: Dict[str, np.ndarray] = {
        "num_atoms": np.int64(num_atoms),
        "charges": np.asarray(charges, dtype=np.int64),
        "positions": np.asarray(positions, dtype=np.float64),
    }
    values = [int(mol_props[1])] + [float(v) for v in mol_props[2:]]
    for name, val in zip(QM9_PROPERTY_NAMES, values):
        out[name] = np.float64(val) if name != "index" else np.int64(val)
    out["omega1"] = np.float64(max(float(w) for w in mol_freq.split()))
    return out


def _pad_stack(molecules: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """Stack a list of molecule dicts, padding ragged arrays to the max size."""
    out = {}
    for key in molecules[0].keys():
        vals = [m[key] for m in molecules]
        if np.ndim(vals[0]) == 0:
            out[key] = np.stack(vals)
        else:
            max_n = max(len(v) for v in vals)
            arr = np.zeros((len(vals), max_n) + np.shape(vals[0])[1:], dtype=np.asarray(vals[0]).dtype)
            for i, v in enumerate(vals):
                arr[i, : len(v)] = v
            out[key] = arr
    return out


def gen_splits_gdb9(excluded_lines: List[str]) -> Dict[str, np.ndarray]:
    """Fixed seed-0 train/valid/test molecule-index split (reference qm9.py:90-160)."""
    excluded = []
    for line in excluded_lines:
        parts = line.split()
        if parts:
            try:
                excluded.append(int(parts[0]) - 1)
            except ValueError:
                continue
    if len(excluded) != NUM_EXCLUDED:
        raise ValueError(f"expected {NUM_EXCLUDED} exclusions, got {len(excluded)}")

    included = np.array(sorted(set(range(NUM_GDB9)) - set(excluded)))
    n_mols = NUM_GDB9 - NUM_EXCLUDED
    n_test = int(0.1 * n_mols)
    n_valid = n_mols - (NUM_TRAIN + n_test)

    perm = np.random.RandomState(0).permutation(n_mols)
    train, valid, test = np.split(perm, [NUM_TRAIN, NUM_TRAIN + n_valid])
    return {"train": included[train], "valid": included[valid], "test": included[test]}


def parse_thermo(atomref_lines: List[str]) -> Dict[str, Dict[int, float]]:
    """Thermochemical reference energies per element (reference qm9.py:162-204)."""
    therm: Dict[str, Dict[int, float]] = {t: {} for t in THERMO_TARGETS}
    for line in atomref_lines:
        parts = line.split()
        if not parts or parts[0] not in CHARGE_DICT:
            continue
        for target, value in zip(THERMO_TARGETS, parts[1:]):
            therm[target][CHARGE_DICT[parts[0]]] = float(value)
    return therm


def add_thermo_targets(data: Dict[str, np.ndarray], therm: Dict[str, Dict[int, float]]):
    """Add <prop>_thermo columns: per-molecule summed atomic reference energies."""
    charges = data["charges"]
    for target, per_element in therm.items():
        thermo = np.zeros(len(charges))
        for z, energy in per_element.items():
            thermo += energy * (charges == z).sum(axis=1)
        data[target + "_thermo"] = thermo
    return data


def process_gdb9_tar(tar_path: str, splits: Dict[str, np.ndarray]) -> Dict[str, Dict[str, np.ndarray]]:
    """Parse the GDB9 tarball into per-split padded dicts (the member order
    of the tarball is the molecule index)."""
    out = {}
    with tarfile.open(tar_path, "r") as tar:
        members = tar.getmembers()
        for split, split_idx in splits.items():
            wanted = set(int(i) for i in split_idx)
            molecules = []
            for i, member in enumerate(members):
                if i not in wanted:
                    continue
                f = tar.extractfile(member)
                molecules.append(parse_xyz_gdb9([line.decode("utf-8") for line in f.readlines()]))
            out[split] = _pad_stack(molecules)
    return out


def prepare_qm9(data_dir: str) -> Dict[str, str]:
    """The per-split npz files under ``<data_dir>/QM9``, processed from the
    GDB9 files there when only those exist -> {"train": path, "valid": path,
    "test": path}.  Downloads nothing."""
    qm9_dir = join(data_dir, "QM9")
    datafiles = {s: join(qm9_dir, f"{s}.npz") for s in ("train", "valid", "test")}
    exists = [os.path.exists(p) for p in datafiles.values()]
    if all(exists):
        return datafiles
    if any(exists):
        raise ValueError(f"QM9 only partially processed under {qm9_dir}; delete and retry.")
    raw = {name: join(qm9_dir, name) for name in (GDB9_TAR, GDB9_EXCLUDED, GDB9_THERMO)}
    missing = [p for p in raw.values() if not os.path.exists(p)]
    if missing:
        # where the JAX package downloads (bio_diffusion_tpu/data/qm9.py:177-191)
        raise RuntimeError(
            f"QM9 is not on disk and the port does not download it (missing {missing}). "
            f"In offline environments, place the processed train/valid/test .npz files under "
            f"{qm9_dir} (same layout as the EDM reference pipeline), or the GDB9 tarball "
            f"{GDB9_TAR} with {GDB9_EXCLUDED} and {GDB9_THERMO}.")
    log.info("Processing the GDB9 tarball under %s ...", qm9_dir)
    with open(raw[GDB9_EXCLUDED]) as f:
        splits = gen_splits_gdb9(f.readlines())
    data = process_gdb9_tar(raw[GDB9_TAR], splits)
    with open(raw[GDB9_THERMO]) as f:
        therm = parse_thermo(f.readlines())
    for split in data:
        np.savez_compressed(datafiles[split], **add_thermo_targets(data[split], therm))
    return datafiles


def _remove_hydrogens(data: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Drop H atoms and re-center (reference edm/utils.py:168-191)."""
    pos, charges = data["positions"], data["charges"]
    new_pos = np.zeros_like(pos)
    new_charges = np.zeros_like(charges)
    for i in range(len(pos)):
        m = charges[i] > 1
        p = pos[i][m]
        if len(p):
            p = p - p.mean(axis=0)
        n = int(m.sum())
        new_pos[i, :n] = p
        new_charges[i, :n] = charges[i][m]
    out = dict(data)
    out["positions"] = new_pos
    out["charges"] = new_charges
    out["num_atoms"] = (new_charges > 0).sum(axis=1)
    return out


def load_qm9_datasets(
    data_dir: str,
    dataset: str = "QM9",
    remove_h: bool = False,
    subtract_thermo: bool = True,
    num_pts: Optional[Dict[str, int]] = None,
    remove_zero_charge_molecules: bool = True,
    convert_to_ev: bool = True,
) -> Dict[str, DenseDataset]:
    """Load QM9 splits as DenseDatasets (reference initialize_datasets +
    ProcessedDataset + unit conversion, rolled together)."""
    datafiles = prepare_qm9(data_dir)
    datasets = {}
    for split, path in datafiles.items():
        with np.load(path) as f:
            datasets[split] = {k: np.array(v) for k, v in f.items()}

    # first/second-half re-splits of train (fixed seed-42 permutation)
    if dataset in ("QM9_second_half", "QM9_first_half"):
        n = len(datasets["train"]["num_atoms"])
        perm = np.random.RandomState(42).permutation(n)
        sl = perm[n // 2:] if dataset == "QM9_second_half" else perm[: n // 2]
        datasets["train"] = {k: v[sl] for k, v in datasets["train"].items()}
    elif dataset != "QM9":
        raise ValueError(f"Unknown QM9 variant {dataset}")

    if remove_h:
        datasets = {k: _remove_hydrogens(v) for k, v in datasets.items()}

    # global species list
    all_species = np.unique(np.concatenate([d["charges"].reshape(-1) for d in datasets.values()]))
    all_species = all_species[all_species > 0]

    out = {}
    for split, data in datasets.items():
        if remove_zero_charge_molecules:
            keep = data["charges"].sum(-1) > 0
            data = {k: v[keep] for k, v in data.items()}
        if subtract_thermo:
            for key in [k.split("_")[0] for k in data if k.endswith("_thermo")]:
                data[key] = data[key] - data[key + "_thermo"]
        if convert_to_ev:
            for key, factor in QM9_TO_EV.items():
                if key in data:
                    data[key] = data[key] * factor
        if num_pts and num_pts.get(split, -1) > 0:
            data = {k: v[: num_pts[split]] for k, v in data.items()}
        data["one_hot"] = (data["charges"][..., None] == all_species[None, None, :]).astype(np.float32)
        out[split] = DenseDataset(data, included_species=all_species)
    return out
