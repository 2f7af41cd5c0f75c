"""Protein-pocket data: dataset tables, joint ligand+pocket batches, pockets.

Copy of ``bio_diffusion_tpu/data/pocket.py`` without jax (numpy only; the
same seed gives the same arrays).  The Binding MOAD / CrossDocked tables of
the reference (atom and residue encoders, bond tables, radii, histograms,
the joint ligand/pocket size histogram) load from the port's own copy of
the compressed assets in ``data/assets/``.  A joint graph holds the ligand
nodes first and the pocket nodes (one CA atom a residue) after, with the
pocket rows flagged as fixed: the rows RePaint inpainting keeps
(``EquivariantVariationalDiffusion.inpaint``).  The structures themselves
are not in the repository; ``synthetic_pocket_joint_dataset`` substitutes
their shape.
"""

from __future__ import annotations

import gzip
import json
import os
import warnings
from functools import lru_cache
from typing import Any, Dict, Optional, Tuple

import numpy as np

from bio_diffusion_torch.data.batch import DenseDataset, DenseMolBatch

_ASSET_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets")


@lru_cache(maxsize=1)
def load_pocket_dataset_params() -> Dict[str, Dict[str, Any]]:
    """``dataset_params['bindingmoad' | 'crossdock_full' | 'crossdock']``."""
    with gzip.open(os.path.join(_ASSET_DIR, "pocket_dataset_params.json.gz"), "rt") as f:
        meta = json.load(f)
    arrays = np.load(os.path.join(_ASSET_DIR, "pocket_dataset_params.npz"))
    out: Dict[str, Dict[str, Any]] = {k: dict(v) for k, v in meta.items()}
    for key in arrays.files:
        name, field = key.split("__", 1)
        out[name][field] = arrays[key]
    return out


def get_pocket_dataset_info(name: str) -> Dict[str, Any]:
    params = load_pocket_dataset_params()
    if name not in params:
        raise ValueError(f"Unknown pocket dataset {name}; have {sorted(params)}")
    info = dict(params[name])
    info.setdefault("name", name)
    return info


class JointLigandPocketBatch:
    """Dense joint graph ``[B, Nl + Np]``: ligand nodes first, pocket nodes
    after; one-hot ``[ligand types | residue types]``; ``fixed_mask`` flags
    the pocket rows (the conditioning that inpainting keeps)."""

    def __init__(self, ligand_x: np.ndarray, ligand_one_hot: np.ndarray, ligand_mask: np.ndarray,
                 pocket_x: np.ndarray, pocket_one_hot: np.ndarray, pocket_mask: np.ndarray):
        b, nl, kl = ligand_one_hot.shape
        np_, kp = pocket_one_hot.shape[1:]
        self.x = np.concatenate([ligand_x, pocket_x], axis=1).astype(np.float32)
        one_hot = np.zeros((b, nl + np_, kl + kp), np.float32)
        one_hot[:, :nl, :kl] = ligand_one_hot
        one_hot[:, nl:, kl:] = pocket_one_hot
        self.one_hot = one_hot
        self.node_mask = np.concatenate([ligand_mask, pocket_mask], axis=1).astype(np.float32)
        self.fixed_mask = np.concatenate([np.zeros_like(ligand_mask), pocket_mask], axis=1).astype(np.float32)
        self.num_ligand_nodes = nl
        self.num_pocket_nodes = np_

    def as_dense_batch(self) -> DenseMolBatch:
        b, n = self.node_mask.shape
        return DenseMolBatch(x=self.x, one_hot=self.one_hot, charges=np.zeros((b, n, 1), np.float32),
                             node_mask=self.node_mask, context=None)


def sample_joint_sizes(dataset_name: str, num_samples: int, rng: np.random.Generator,
                       pocket_size: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
    """(ligand_size, pocket_size) pairs from the joint size histogram (rows
    ligand sizes, columns pocket sizes; size 0 zeroed), or ligand sizes for
    one ``pocket_size`` from its column."""
    info = get_pocket_dataset_info(dataset_name)
    joint = np.asarray(info["n_nodes"], dtype=np.float64).copy()
    joint[0, :] = 0.0
    joint[:, 0] = 0.0
    if pocket_size is not None:
        col = joint[:, pocket_size]
        lig = rng.choice(len(col), size=num_samples, p=col / col.sum())
        return lig, np.full(num_samples, pocket_size)
    flat = joint.reshape(-1)
    idx = rng.choice(len(flat), size=num_samples, p=flat / flat.sum())
    lig, pock = np.unravel_index(idx, joint.shape)
    return lig, pock


def ligand_dataset_info(dataset_name: str) -> Dict[str, Any]:
    """The statistics table of the LIGAND atom space of a pocket dataset
    (stability, atom-type KL and xyz files of generated ligands), with the
    dataset's own bond tables."""
    info = get_pocket_dataset_info(dataset_name)
    atom_encoder = dict(info["atom_encoder"])
    joint = np.asarray(info["n_nodes"], dtype=np.float64)
    n_nodes = {i: float(c) for i, c in enumerate(joint.sum(axis=1)) if i > 0 and c > 0}
    return {
        "name": f"{dataset_name}_ligand",
        "atom_encoder": atom_encoder,
        "atom_decoder": list(info["atom_decoder"]),
        "atom_types": {atom_encoder[e]: float(c) for e, c in info["atom_hist"].items()},
        "n_nodes": n_nodes,
        "max_n_nodes": int(max(n_nodes)),
        "with_h": False,
        "bonds1": np.asarray(info["bonds1"], dtype=np.float64),
        "bonds2": np.asarray(info["bonds2"], dtype=np.float64),
        "bonds3": np.asarray(info["bonds3"], dtype=np.float64),
        "colors_dic": list(info.get("colors_dic", [])) or None,
        "radius_dic": np.asarray(info["radius_dic"], dtype=np.float64),
    }


def joint_dataset_info(dataset_name: str) -> Dict[str, Any]:
    """The statistics table of the JOINT graph the model is trained on:
    ligand types in one-hot columns ``[0, Kl)``, residue types (``res_A``
    ...) in ``[Kl, Kl + Kp)``; sizes are ligand + pocket totals."""
    info = get_pocket_dataset_info(dataset_name)
    lig_dec = list(info["atom_decoder"])
    decoder = lig_dec + [f"res_{a}" for a in info["aa_decoder"]]
    kl = len(lig_dec)
    atom_types = {info["atom_encoder"][e]: float(c) for e, c in info["atom_hist"].items()}
    for a, c in info["aa_hist"].items():
        atom_types[kl + info["aa_encoder"][a]] = float(c)
    joint = np.asarray(info["n_nodes"], dtype=np.float64)
    totals: Dict[int, float] = {}
    for li in range(joint.shape[0]):
        for pi in range(joint.shape[1]):
            if li > 0 and pi > 0 and joint[li, pi] > 0:
                totals[li + pi] = totals.get(li + pi, 0.0) + float(joint[li, pi])
    return {
        "name": dataset_name,
        "atom_encoder": {s: i for i, s in enumerate(decoder)},
        "atom_decoder": decoder,
        "atom_types": atom_types,
        "num_ligand_atom_types": kl,
        "n_nodes": totals,
        "max_n_nodes": int(max(totals)),
        "with_h": False,
    }


# PDB three-letter -> one-letter residue codes (the aa_encoder alphabet)
THREE_TO_ONE = {
    "ALA": "A", "CYS": "C", "ASP": "D", "GLU": "E", "PHE": "F",
    "GLY": "G", "HIS": "H", "ILE": "I", "LYS": "K", "LEU": "L",
    "MET": "M", "ASN": "N", "PRO": "P", "GLN": "Q", "ARG": "R",
    "SER": "S", "THR": "T", "VAL": "V", "TRP": "W", "TYR": "Y",
    # common nonstandard residues mapped to their parent
    "MSE": "M", "SEC": "C", "PYL": "K", "HSD": "H", "HSE": "H",
}


def load_pocket_pdb(path: str, pocket_name: str = "bindingmoad", chain: Optional[str] = None,
                    center: Optional[np.ndarray] = None, radius: Optional[float] = None,
                    ligand_resname: Optional[str] = None) -> Tuple[np.ndarray, np.ndarray]:
    """The CA-level pocket of a PDB file -> ``(coords [P, 3] float32,
    residue types [P] int64)`` in the dataset's ``aa_encoder`` alphabet.

    Reads the first model only; keeps ATOM records named CA, optionally of
    one ``chain``, of the first alternate location (blank or ``A``), and
    within ``radius`` of ``center``.  ``ligand_resname`` centres the cut on
    that HETATM residue's centroid (radius 8 A unless given) and raises if
    the file has none.  ATOM CAs whose residue has no ``THREE_TO_ONE``
    entry in the alphabet are skipped and counted in one warning.

    The rule is the JAX package's, kept exactly so that both give the same
    pocket: every HETATM record is set aside before the residue map, so a
    CA written as HETATM (as PDB files write MSE, selenomethionine) is
    dropped and not counted in the warning, although ``THREE_TO_ONE``
    maps MSE to M; an ATOM MSE maps to M.
    """
    aa_enc = get_pocket_dataset_info(pocket_name)["aa_encoder"]
    coords, residues, skipped, het_coords = [], [], 0, []
    with open(path) as f:
        for line in f:
            rec = line[:6].strip()
            if rec == "ENDMDL":
                break
            if rec not in ("ATOM", "HETATM"):
                continue
            try:
                xyz = (float(line[30:38]), float(line[38:46]), float(line[46:54]))
            except ValueError:
                continue
            resname = line[17:20].strip()
            if rec == "HETATM":
                if ligand_resname and resname == str(ligand_resname).strip():
                    het_coords.append(xyz)
                continue
            if line[12:16].strip() != "CA":
                continue
            if chain and line[21].strip() != str(chain):
                continue
            if line[16].strip() not in ("", "A"):
                continue
            one = THREE_TO_ONE.get(resname)
            if one is None or one not in aa_enc:
                skipped += 1
                continue
            coords.append(xyz)
            residues.append(aa_enc[one])
    if ligand_resname:
        if not het_coords:
            raise ValueError(f"no HETATM residue {ligand_resname!r} in {path} to center the pocket on")
        center = np.mean(np.asarray(het_coords, dtype=np.float64), axis=0)
        if radius is None:
            radius = 8.0
    x = np.asarray(coords, dtype=np.float32).reshape(-1, 3)
    aa = np.asarray(residues, dtype=np.int64)
    if center is not None and radius is not None:
        keep = np.linalg.norm(x - np.asarray(center, np.float32)[None], axis=-1) <= float(radius)
        x, aa = x[keep], aa[keep]
    if len(x) == 0:
        raise ValueError(f"no pocket CA atoms extracted from {path} "
                         f"(chain={chain}, radius={radius}, skipped={skipped})")
    if skipped:
        warnings.warn(f"{path}: skipped {skipped} CA atoms with residues outside the aa_encoder alphabet",
                      stacklevel=2)
    return x, aa


def synthetic_pockets(dataset_name: str, pocket_sizes: np.ndarray, rng: np.random.Generator
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Synthetic pockets: CA atoms on a jittered spherical shell (radius
    grown with the residue count, ~5 A apart), residue types drawn from the
    dataset's histogram -> ``(x [B, Np, 3], aa [B, Np], mask [B, Np])``
    padded to ``max(pocket_sizes)``."""
    info = get_pocket_dataset_info(dataset_name)
    aa_probs = np.array([float(info["aa_hist"][a]) for a in info["aa_decoder"]], dtype=np.float64)
    aa_probs /= aa_probs.sum()
    pocket_sizes = np.asarray(pocket_sizes, dtype=np.int64)
    b, np_max = len(pocket_sizes), int(pocket_sizes.max())
    x = np.zeros((b, np_max, 3), dtype=np.float32)
    aa = np.zeros((b, np_max), dtype=np.int64)
    mask = np.zeros((b, np_max), dtype=np.float32)
    for i, n in enumerate(pocket_sizes):
        radius = max(6.0, np.sqrt(n * 5.0 ** 2 / (4.0 * np.pi)) * 2.0)
        dirs = rng.normal(size=(n, 3))
        dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
        r = radius + rng.normal(scale=1.0, size=(n, 1))
        x[i, :n] = dirs * r
        aa[i, :n] = rng.choice(len(aa_probs), size=n, p=aa_probs)
        mask[i, :n] = 1.0
    return x, aa, mask


def synthetic_pocket_joint_dataset(dataset_name: str, num_graphs: int = 256, seed: int = 0,
                                   max_total_nodes: Optional[int] = None) -> DenseDataset:
    """Synthetic joint ligand+pocket graphs in the ``DenseDataset`` schema:
    sizes from the joint histogram (pairs above ``max_total_nodes`` drawn
    again), a synthetic pocket each, the ligand a random-walk chain centred
    in it; one-hot columns as in ``joint_dataset_info``."""
    rng = np.random.default_rng(seed)
    info = get_pocket_dataset_info(dataset_name)
    kl, kp = len(info["atom_decoder"]), len(info["aa_decoder"])
    atom_probs = np.array([float(info["atom_hist"][e]) for e in info["atom_decoder"]], dtype=np.float64)
    atom_probs /= atom_probs.sum()

    lig_sizes, pock_sizes = sample_joint_sizes(dataset_name, num_graphs, rng)
    if max_total_nodes is not None:
        for i in range(num_graphs):
            while lig_sizes[i] + pock_sizes[i] > max_total_nodes:
                l2, p2 = sample_joint_sizes(dataset_name, 1, rng)
                lig_sizes[i], pock_sizes[i] = l2[0], p2[0]
    totals = lig_sizes + pock_sizes
    n_max = int(totals.max())

    pock_x, pock_aa, _ = synthetic_pockets(dataset_name, pock_sizes, rng)
    positions = np.zeros((num_graphs, n_max, 3), dtype=np.float64)
    one_hot = np.zeros((num_graphs, n_max, kl + kp), dtype=np.float32)
    for i in range(num_graphs):
        nl, npk = int(lig_sizes[i]), int(pock_sizes[i])
        steps = rng.normal(size=(nl, 3))
        steps /= np.linalg.norm(steps, axis=-1, keepdims=True)
        lig = np.cumsum(steps * 1.5, axis=0)
        lig -= lig.mean(axis=0)
        positions[i, :nl] = lig
        positions[i, nl: nl + npk] = pock_x[i, :npk]
        lig_types = rng.choice(kl, size=nl, p=atom_probs)
        one_hot[i, np.arange(nl), lig_types] = 1.0
        one_hot[i, nl + np.arange(npk), kl + pock_aa[i, :npk]] = 1.0

    present = one_hot.sum(-1) > 0
    data = {
        "num_atoms": totals.astype(np.int64),
        "num_ligand_atoms": lig_sizes.astype(np.int64),
        "positions": positions,
        # 1-based type ids: the collator takes node presence from charges > 0;
        # the pocket config has no charge channel, so the column is presence only
        "charges": (one_hot.argmax(-1).astype(np.int64) + 1) * present,
        "one_hot": one_hot,
        "index": np.arange(num_graphs, dtype=np.int64),
    }
    return DenseDataset(data, included_species=np.arange(1, kl + kp + 1))
