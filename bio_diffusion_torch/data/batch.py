"""Dense molecule batches (numpy on the host, torch on the device).

Copy of ``bio_diffusion_tpu/data/batch.py`` without jax: a
``DenseMolBatch`` holds statically shaped padded arrays; collation pads every
molecule of a batch to one node count (QM9: the dataset's 29, or a bucket).
``DenseDataset`` carries what the QM9 loader and the sampling evaluation
read.  A batch of a property-conditioned model carries its context: the
normalized property values of each molecule broadcast to its nodes.
:func:`iterate_dense_batches` collates through the compiled
``data/native_loader.py::collate_dense_native`` as the JAX package's does,
bit for bit what :func:`collate_numpy` gives; :func:`collate_dense` pads a
list of molecules of their own sizes.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from bio_diffusion_torch.data import native_loader


@dataclasses.dataclass
class DenseMolBatch:
    """Statically shaped molecule batch: ``x [B, N, 3]`` positions (padded
    rows 0), ``one_hot [B, N, K]`` atom types, ``charges [B, N, 1]`` atomic
    numbers, ``node_mask [B, N]`` 0/1, ``context [B, N, C]`` per-node
    conditioning features (padded rows 0) or None; numpy arrays or torch
    tensors."""

    x: object
    one_hot: object
    charges: object
    node_mask: object
    context: object = None

    def to(self, device) -> "DenseMolBatch":
        """float32 torch tensors on ``device`` (a None context stays None)."""
        return DenseMolBatch(*(None if getattr(self, f.name) is None
                               else torch.as_tensor(getattr(self, f.name), dtype=torch.float32).to(device)
                               for f in dataclasses.fields(self)))


def round_up(n: int, multiple: int) -> int:
    if multiple <= 1:
        return n
    return ((n + multiple - 1) // multiple) * multiple


def select_bucket(max_nodes: int, bucket_sizes: Optional[Sequence[int]], pad_to_multiple: int = 1) -> int:
    """The padded node count of a batch."""
    if bucket_sizes:
        for b in sorted(bucket_sizes):
            if max_nodes <= b:
                return b
        return max(bucket_sizes)
    return round_up(max_nodes, pad_to_multiple)


def broadcast_context(context: np.ndarray, node_mask: np.ndarray) -> np.ndarray:
    """Per-molecule values ``[B, C]`` -> per-node ``[B, N, C]``, padded rows 0."""
    context = np.asarray(context, dtype=np.float32)
    b, n = node_mask.shape
    out = np.broadcast_to(context[:, None, :], (b, n, context.shape[-1])).copy()
    return out * np.asarray(node_mask, dtype=np.float32)[..., None]


def collate_dense(positions: Sequence[np.ndarray], one_hot: Sequence[np.ndarray],
                  charges: Optional[Sequence[np.ndarray]], pad_to: int,
                  context: Optional[np.ndarray] = None) -> DenseMolBatch:
    """Per-molecule arrays (``positions[i] [n_i, 3]``, ``one_hot[i] [n_i, K]``,
    ``charges[i]`` with n_i values or None) padded into a ``DenseMolBatch``
    of ``pad_to`` nodes (float32 numpy; ``charges [B, N, 1]``, zeros without
    them); ``context [B, C]`` per molecule is broadcast to its nodes
    (``broadcast_context``, the reference's ``prepare_context``)."""
    b = len(positions)
    x = np.zeros((b, pad_to, 3), dtype=np.float32)
    oh = np.zeros((b, pad_to, one_hot[0].shape[-1]), dtype=np.float32)
    ch = np.zeros((b, pad_to, 1), dtype=np.float32)
    mask = np.zeros((b, pad_to), dtype=np.float32)
    for i, (p, o) in enumerate(zip(positions, one_hot)):
        n = len(p)
        x[i, :n] = p
        oh[i, :n] = o
        mask[i, :n] = 1.0
        if charges is not None:
            ch[i, :n, 0] = np.asarray(charges[i]).reshape(-1)[:n]
    ctx = None if context is None else broadcast_context(context, mask)
    return DenseMolBatch(x=x, one_hot=oh, charges=ch, node_mask=mask, context=ctx)


class DenseDataset:
    """In-memory dense dataset: a dict of ``[M, Nmax(, .)]`` arrays
    (positions, charges, one_hot, num_atoms, property columns)."""

    def __init__(self, data: Dict[str, np.ndarray], included_species: np.ndarray):
        self.data = data
        self.included_species = np.asarray(included_species)

    def __len__(self) -> int:
        return len(self.data["num_atoms"])

    @property
    def num_species(self) -> int:
        return len(self.included_species)

    @property
    def max_charge(self) -> int:
        return int(self.included_species.max())

    def property_values(self, key: str) -> np.ndarray:
        return self.data[key]

    def stats(self) -> Dict[str, Tuple[float, float]]:
        """(mean, std) of every 1-D float column."""
        out = {}
        for key, val in self.data.items():
            val = np.asarray(val)
            if val.ndim == 1 and np.issubdtype(val.dtype, np.floating):
                out[key] = (float(val.mean()), float(val.std()))
        return out


def collate_numpy(dataset: "DenseDataset", sel: np.ndarray, n_pad: int
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """The molecules ``sel`` of ``dataset`` padded to ``n_pad`` nodes with
    numpy -> ``(x [B, n_pad, 3], one_hot [B, n_pad, K], charges [B, n_pad, 1],
    mask [B, n_pad])``, float32; a row is real where its charge is > 0."""
    positions, charges, one_hot = (dataset.data[k] for k in ("positions", "charges", "one_hot"))
    b = len(sel)
    x = np.zeros((b, n_pad, 3), dtype=np.float32)
    oh = np.zeros((b, n_pad, one_hot.shape[-1]), dtype=np.float32)
    ch = np.zeros((b, n_pad, 1), dtype=np.float32)
    mask = np.zeros((b, n_pad), dtype=np.float32)
    src_n = min(n_pad, positions.shape[1])
    x[:, :src_n] = positions[sel][:, :src_n]
    oh[:, :src_n] = one_hot[sel][:, :src_n]
    ch[:, :src_n, 0] = charges[sel][:, :src_n]
    mask[:, :src_n] = (charges[sel][:, :src_n] > 0).astype(np.float32)
    x *= mask[..., None]  # missing nodes carry no geometry
    oh *= mask[..., None]
    return x, oh, ch, mask


def iterate_dense_batches(
    dataset: DenseDataset,
    batch_size: int,
    rng: Optional[np.random.Generator] = None,
    shuffle: bool = True,
    drop_last: bool = True,
    pad_to: Optional[int] = None,
    pad_to_multiple: int = 1,
    bucket_sizes: Optional[Sequence[int]] = None,
    conditioning: Sequence[str] = (),
    property_norms: Optional[Dict[str, Dict[str, float]]] = None,
) -> Iterator[DenseMolBatch]:
    """Yield numpy ``DenseMolBatch``es from a ``DenseDataset`` (shuffled by
    ``rng`` when ``shuffle``), each padded to ``pad_to`` or to its bucket.
    With ``conditioning`` (property names), each batch carries the context
    ``(value - mean) / mad`` of those properties (``property_norms``).

    Collation: ``native_loader.collate_dense_native`` wherever a host C++
    compiler is found (``native_available``); its library is built on the
    first batch, and a failed build raises.  It reads the dataset's float64
    positions and int64 charges in place; other dtypes, and a machine
    without a compiler, collate with :func:`collate_numpy`."""
    if conditioning and property_norms is None:
        raise ValueError("conditioning requires property_norms")
    m = len(dataset)
    idx = np.arange(m)
    if shuffle:
        if rng is None:
            raise ValueError("shuffle requires an rng")
        rng.shuffle(idx)
    use_native = native_loader.native_available()
    for start in range(0, m, batch_size):
        sel = idx[start: start + batch_size]
        if len(sel) < batch_size and drop_last:
            break
        num_atoms = dataset.data["num_atoms"][sel]
        n_pad = pad_to if pad_to is not None else select_bucket(
            int(num_atoms.max()), bucket_sizes, pad_to_multiple)
        collated = None
        if use_native:
            collated = native_loader.collate_dense_native(
                dataset.data["positions"], dataset.data["charges"], sel, n_pad, dataset.included_species)
        if collated is not None:
            x, oh, ch, mask = collated
            ch = ch[..., None]
        else:
            x, oh, ch, mask = collate_numpy(dataset, sel, n_pad)
        ctx = None
        if conditioning:
            cols = [(dataset.data[p][sel].astype(np.float32) - property_norms[p]["mean"])
                    / property_norms[p]["mad"] for p in conditioning]
            ctx = broadcast_context(np.stack(cols, axis=-1), mask)
        yield DenseMolBatch(x=x, one_hot=oh, charges=ch, node_mask=mask, context=ctx)
