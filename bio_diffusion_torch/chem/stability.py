"""Distance-based bond perception and molecular stability metrics.

Copy of ``bio_diffusion_tpu/chem/stability.py`` (the port imports nothing of
the JAX package), the behavioral counterpart of the reference's chem metrics
(src/datamodules/components/edm/__init__.py:24-122): bond orders from
pairwise distances vs empirical bond-length tables (+margins), then per-atom
valence checks against allowed valences, vectorized with numpy over a
padded ``[B, N]`` batch (host-side evaluation code, not the device path).
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np

from bio_diffusion_torch.chem import constants as C


def get_bond_length_arrays(atom_mapping: Dict[str, int]) -> List[np.ndarray]:
    """Dense [num_types, num_types] bond-length tables for orders 1..3."""
    bond_arrays = []
    for bond_dict in (C.BONDS1, C.BONDS2, C.BONDS3):
        arr = np.zeros((len(atom_mapping), len(atom_mapping)))
        for a1, i1 in atom_mapping.items():
            for a2, i2 in atom_mapping.items():
                arr[i1, i2] = bond_dict.get(a1, {}).get(a2, 0)
        assert np.all(arr == arr.T)
        bond_arrays.append(arr)
    return bond_arrays


def get_bond_order(atom1: str, atom2: str, distance: float) -> int:
    """Single-pair bond order; distance in Angstrom."""
    distance = 100 * distance  # Angstrom -> pm
    if C.BONDS3.get(atom1, {}).get(atom2) is not None and distance < C.BONDS3[atom1][atom2] + C.MARGIN3:
        return 3
    if C.BONDS2.get(atom1, {}).get(atom2) is not None and distance < C.BONDS2[atom1][atom2] + C.MARGIN2:
        return 2
    if C.BONDS1.get(atom1, {}).get(atom2) is not None and distance < C.BONDS1[atom1][atom2] + C.MARGIN1:
        return 1
    return 0


def get_bond_order_batch(
    atoms1: np.ndarray,
    atoms2: np.ndarray,
    distances: np.ndarray,
    dataset_info: Dict[str, Any],
    limit_bonds_to_one: bool = False,
) -> np.ndarray:
    """Vectorized bond orders for atom-type index pairs; distances in Angstrom.

    Matches the reference's assignment order (single overwritten by double
    overwritten by triple; :61-87).  GEOM limits bonds to order one.
    """
    distances = 100 * np.asarray(distances)
    bonds1 = np.asarray(dataset_info["bonds1"])
    bonds2 = np.asarray(dataset_info["bonds2"])
    bonds3 = np.asarray(dataset_info["bonds3"])
    atoms1 = np.asarray(atoms1, dtype=np.int64)
    atoms2 = np.asarray(atoms2, dtype=np.int64)

    order = np.zeros_like(atoms1)
    order[distances < bonds1[atoms1, atoms2] + C.MARGIN1] = 1
    order[distances < bonds2[atoms1, atoms2] + C.MARGIN2] = 2
    order[distances < bonds3[atoms1, atoms2] + C.MARGIN3] = 3
    if limit_bonds_to_one:
        order[order > 1] = 1
    return order


def _allowed_bond_table(dataset_info: Dict[str, Any], max_valence: int = 16) -> np.ndarray:
    """[num_types, max_valence+1] boolean table of allowed valences."""
    decoder = dataset_info["atom_decoder"]
    table = np.zeros((len(decoder), max_valence + 1), dtype=bool)
    for i, sym in enumerate(decoder):
        allowed = C.ALLOWED_BONDS[sym]
        if isinstance(allowed, int):
            allowed = [allowed]
        for v in allowed:
            if v <= max_valence:
                table[i, v] = True
    return table


def ensure_bond_tables(dataset_info: Dict[str, Any]) -> Dict[str, Any]:
    """Install bonds1/2/3 arrays into a dataset_info dict if missing."""
    if not all(k in dataset_info for k in ("bonds1", "bonds2", "bonds3")):
        b1, b2, b3 = get_bond_length_arrays(dataset_info["atom_encoder"])
        dataset_info = dict(dataset_info)
        dataset_info["bonds1"], dataset_info["bonds2"], dataset_info["bonds3"] = b1, b2, b3
    return dataset_info


def batch_molecular_stability(
    positions: np.ndarray,
    atom_types: np.ndarray,
    node_mask: np.ndarray,
    dataset_info: Dict[str, Any],
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Fully-vectorized stability over a padded [B, N] batch.

    Returns (mol_stable [B] bool, stable_atoms [B] int, num_atoms [B] int).
    """
    dataset_info = ensure_bond_tables(dataset_info)
    positions = np.asarray(positions)
    atom_types = np.asarray(atom_types, dtype=np.int64)
    node_mask = np.asarray(node_mask).astype(bool)
    b, n = atom_types.shape
    limit_one = "GEOM" in str(dataset_info.get("name", ""))

    diff = positions[:, :, None, :] - positions[:, None, :, :]
    dists = np.sqrt((diff**2).sum(-1))  # [B, N, N]
    a1 = np.broadcast_to(atom_types[:, :, None], (b, n, n))
    a2 = np.broadcast_to(atom_types[:, None, :], (b, n, n))
    order = get_bond_order_batch(
        a1.reshape(-1), a2.reshape(-1), dists.reshape(-1), dataset_info,
        limit_bonds_to_one=limit_one,
    ).reshape(b, n, n)

    pair_mask = node_mask[:, :, None] & node_mask[:, None, :]
    eye = np.eye(n, dtype=bool)[None]
    order = order * (pair_mask & ~eye)
    nr_bonds = order.sum(axis=2)  # [B, N]

    valence_ok = _allowed_bond_table(dataset_info)
    nr_clipped = np.minimum(nr_bonds, valence_ok.shape[1] - 1)
    stable = valence_ok[atom_types, nr_clipped] & node_mask

    num_atoms = node_mask.sum(axis=1)
    stable_atoms = stable.sum(axis=1)
    mol_stable = stable_atoms == num_atoms
    return mol_stable, stable_atoms, num_atoms
