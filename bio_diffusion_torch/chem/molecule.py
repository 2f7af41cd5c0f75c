"""Molecule I/O and RDKit molecule construction (host-side).

Copy of ``bio_diffusion_tpu/chem/molecule.py`` (the port imports nothing of
the JAX package), the counterpart of the reference's molecule I/O
(src/models/components/__init__.py:325-411: save_xyz_file/write_sdf_file/
load_molecule_xyz) and RDKit molecule construction
(src/datamodules/components/edm/rdkit_functions.py:209-401: build_molecule /
make_mol_edm / process_molecule / uff_relax).  The OpenBabel bond perception
of the JAX package is not ported.

The xyz files need numpy only and are byte-identical to the JAX package's.
RDKit is an optional host dependency, import-gated with a clear error, so
the device path never depends on it.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Dict, List, Tuple

import numpy as np

from bio_diffusion_torch.chem.stability import ensure_bond_tables, get_bond_order_batch

try:
    from rdkit import Chem
    from rdkit.Chem import AllChem
    from rdkit.Geometry import Point3D

    RDKIT_AVAILABLE = True
except ImportError:  # zero-dep environments: metrics degrade gracefully
    Chem = None
    RDKIT_AVAILABLE = False


def _require_rdkit():
    if not RDKIT_AVAILABLE:
        raise ImportError(
            "RDKit is required for molecule construction/validity metrics. "
            "Install rdkit (host-side only; the device path does not need it)."
        )


# ---------------------------------------------------------------------------
# xyz / sdf I/O
# ---------------------------------------------------------------------------

def save_xyz_files(
    path: str,
    positions: np.ndarray,  # [M, N, 3] padded
    one_hot: np.ndarray,  # [M, N, K]
    node_mask: np.ndarray,  # [M, N]
    dataset_info: Dict[str, Any],
    name: str = "molecule",
    id_from: int = 0,
) -> List[str]:
    """Write one .xyz per molecule (reference save_xyz_file)."""
    os.makedirs(path, exist_ok=True)
    decoder = dataset_info["atom_decoder"]
    files = []
    for i in range(len(positions)):
        m = node_mask[i] > 0
        pos = positions[i][m]
        types = one_hot[i][m].argmax(-1)
        fn = os.path.join(path, f"{name}_{i + id_from:03d}.xyz")
        with open(fn, "w") as f:
            f.write(f"{len(pos)}\n\n")
            for a, p in zip(types, pos):
                f.write("%s %.9f %.9f %.9f\n" % (decoder[int(a)], p[0], p[1], p[2]))
        files.append(fn)
    return files


def load_molecule_xyz(path: str, dataset_info: Dict[str, Any]) -> Tuple[np.ndarray, np.ndarray]:
    """Read one xyz -> (positions [n,3], one_hot [n,K])."""
    encoder = dataset_info["atom_encoder"]
    with open(path, encoding="utf8") as f:
        n = int(f.readline())
        f.readline()
        one_hot = np.zeros((n, len(dataset_info["atom_decoder"])), dtype=np.float32)
        positions = np.zeros((n, 3), dtype=np.float32)
        for i in range(n):
            parts = f.readline().split()
            one_hot[i, encoder[parts[0]]] = 1.0
            positions[i] = [float(v) for v in parts[1:4]]
    return positions, one_hot


def write_sdf_file(sdf_path: Path, molecules: List[Any]) -> None:
    _require_rdkit()
    writer = Chem.SDWriter(str(sdf_path))
    for mol in molecules:
        if mol is not None:
            writer.write(mol)
    writer.close()


# ---------------------------------------------------------------------------
# RDKit molecule construction
# ---------------------------------------------------------------------------

_BOND_TYPES = [None, "SINGLE", "DOUBLE", "TRIPLE", "AROMATIC"]


def make_mol_edm(
    positions: np.ndarray,
    atom_types: np.ndarray,
    dataset_info: Dict[str, Any],
    add_coords: bool = True,
):
    """Distance-based bond-order molecule (reference make_mol_edm,
    rdkit_functions.py:276-321): lower-triangular pair scan with the EDM
    bond tables."""
    _require_rdkit()
    dataset_info = ensure_bond_tables(dataset_info)
    atom_types = np.asarray(atom_types, dtype=np.int64)
    n = len(positions)
    limit_one = "GEOM" in str(dataset_info.get("name", ""))

    mol = Chem.RWMol()
    decoder = dataset_info["atom_decoder"]
    for t in atom_types:
        mol.AddAtom(Chem.Atom(decoder[int(t)]))

    ii, jj = np.tril_indices(n, k=-1)
    d = np.linalg.norm(positions[ii] - positions[jj], axis=-1)
    orders = get_bond_order_batch(
        atom_types[ii], atom_types[jj], d, dataset_info, limit_bonds_to_one=limit_one
    )
    for i, j, o in zip(ii, jj, orders):
        if o > 0:
            mol.AddBond(int(i), int(j), getattr(Chem.BondType, _BOND_TYPES[int(o)]))

    mol = mol.GetMol()
    if add_coords:
        conf = Chem.Conformer(n)
        for i, p in enumerate(positions):
            conf.SetAtomPosition(i, Point3D(float(p[0]), float(p[1]), float(p[2])))
        mol.AddConformer(conf)
    return mol


def build_molecule(
    positions: np.ndarray,
    atom_types: np.ndarray,
    dataset_info: Dict[str, Any],
    add_coords: bool = True,
):
    """RDKit Mol from positions + types (reference build_molecule :209-235)."""
    return make_mol_edm(positions, atom_types, dataset_info, add_coords=add_coords)


def process_molecule(
    rdmol,
    add_hydrogens: bool = False,
    sanitize: bool = False,
    relax_iter: int = 0,
    largest_frag: bool = False,
):
    """Optional sanitization / largest-fragment / UFF relaxation pipeline
    (reference process_molecule :324-380).  Returns None if a step fails."""
    _require_rdkit()
    mol = Chem.Mol(rdmol)
    if sanitize:
        try:
            Chem.SanitizeMol(mol)
        except ValueError:
            return None
    if add_hydrogens:
        mol = Chem.AddHs(mol, addCoords=(len(mol.GetConformers()) > 0))
    if largest_frag:
        frags = Chem.GetMolFrags(mol, asMols=True, sanitizeFrags=False)
        mol = max(frags, default=mol, key=lambda m: m.GetNumAtoms())
        if sanitize:
            try:
                Chem.SanitizeMol(mol)
            except ValueError:
                return None
    if relax_iter > 0:
        if not uff_relax(mol, relax_iter):
            return None
        if sanitize:
            try:
                Chem.SanitizeMol(mol)
            except ValueError:
                return None
    return mol


def uff_relax(mol, max_iter: int = 200) -> bool:
    """UFF force-field relaxation; returns convergence flag (reference :383-401)."""
    _require_rdkit()
    try:
        more_iters_needed = AllChem.UFFOptimizeMolecule(mol, maxIters=max_iter)
        return not more_iters_needed
    except Exception:
        return False
