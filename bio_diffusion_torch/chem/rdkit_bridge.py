"""RDKit-based sample-quality metrics: validity / uniqueness / novelty.

Copy of ``bio_diffusion_tpu/chem/rdkit_bridge.py`` (the port imports nothing
of the JAX package), the counterpart of the reference's
BasicMolecularMetrics (src/datamodules/components/edm/rdkit_functions.py:
121-197).  Without RDKit, ``build_molecular_metrics`` returns None and the
stability metrics (RDKit-free) carry the evaluation.  Unlike the JAX
package's copy, which reads every SMILES file with ``np.load``, it reads
GEOM-Drugs' text list (``GEOM_drugs_smiles.txt``) as text.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from bio_diffusion_torch.chem.molecule import RDKIT_AVAILABLE, build_molecule

if RDKIT_AVAILABLE:
    from rdkit import Chem


def mol2smiles(mol) -> Optional[str]:
    try:
        Chem.SanitizeMol(mol)
    except ValueError:
        return None
    return Chem.MolToSmiles(mol)


def load_smiles_list(path: str) -> List[str]:
    """The training-set SMILES for novelty: QM9's ``.npy`` array, or a text
    file with one SMILES a line (GEOM-Drugs' ``GEOM_drugs_smiles.txt``)."""
    if str(path).endswith(".txt"):
        with open(path) as f:
            return [line.strip() for line in f if line.strip()]
    return [str(s) for s in np.load(path, allow_pickle=True)]


def build_molecular_metrics(dataset_info, smiles_filepath=None):
    """``BasicMolecularMetrics`` when RDKit is importable, else None — the
    single construction point shared by in-training sampling eval
    (train/loop.py) and the eval CLI.  Loads the training-set SMILES list
    (``load_smiles_list``) for novelty when the file exists."""
    import os

    if not RDKIT_AVAILABLE:
        return None
    smiles = None
    if smiles_filepath and os.path.exists(str(smiles_filepath)):
        smiles = load_smiles_list(smiles_filepath)
    return BasicMolecularMetrics(dataset_info, dataset_smiles_list=smiles)


class BasicMolecularMetrics:
    """Validity / uniqueness / novelty over (positions, atom_types) samples."""

    def __init__(
        self,
        dataset_info: Dict[str, Any],
        dataset_smiles_list: Optional[Sequence[str]] = None,
    ):
        self.dataset_info = dataset_info
        self.dataset_smiles_list = set(dataset_smiles_list) if dataset_smiles_list is not None else None

    def compute_validity(self, generated: Sequence[Tuple[np.ndarray, np.ndarray]]):
        if not RDKIT_AVAILABLE:
            return [], -1.0
        valid = []
        for positions, atom_types in generated:
            mol = build_molecule(np.asarray(positions), np.asarray(atom_types), self.dataset_info)
            smiles = mol2smiles(mol)
            if smiles is not None:
                # evaluate the largest fragment (reference :148-155)
                mol_frags = Chem.rdmolops.GetMolFrags(mol, asMols=True, sanitizeFrags=False)
                largest = max(mol_frags, default=mol, key=lambda m: m.GetNumAtoms())
                smiles = mol2smiles(largest)
                if smiles is not None:
                    valid.append(smiles)
        return valid, len(valid) / max(len(generated), 1)

    def compute_uniqueness(self, valid: List[str]):
        if not valid:
            return [], 0.0
        unique = list(set(valid))
        return unique, len(unique) / len(valid)

    def compute_novelty(self, unique: List[str]):
        if not unique or self.dataset_smiles_list is None:
            return [], 0.0
        novel = [s for s in unique if s not in self.dataset_smiles_list]
        return novel, len(novel) / len(unique)

    def evaluate(self, generated: Sequence[Tuple[np.ndarray, np.ndarray]]):
        """Returns (validity, uniqueness, novelty, unique_smiles)."""
        if not RDKIT_AVAILABLE:
            return -1.0, -1.0, -1.0, []
        valid, validity = self.compute_validity(generated)
        unique, uniqueness = self.compute_uniqueness(valid)
        if self.dataset_smiles_list is not None:
            _, novelty = self.compute_novelty(unique)
        else:
            novelty = -1.0
        return validity, uniqueness, novelty, unique

