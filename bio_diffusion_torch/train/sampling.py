"""Host-side sampling drivers: the reverse-diffusion loop, batching, analysis.

Port of ``bio_diffusion_tpu/train/sampling.py`` (``SegmentedSampler``,
``make_node_mask``, ``sample_molecules``, ``analyze_samples``) with the JAX
package's signatures, property contexts included.  PyTorch runs
eagerly, so the sampler is a Python loop over the reverse steps on the EVD's
device; randomness comes from the ``torch.Generator`` each call is given.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from bio_diffusion_torch.chem.stability import batch_molecular_stability, ensure_bond_tables
from bio_diffusion_torch.data.batch import broadcast_context
from bio_diffusion_torch.models.distributions import CategoricalDistribution, NumNodesDistribution


class SegmentedSampler:
    """Reverse diffusion for one EVD: prior draw, T ancestral steps, decode.
    ``runs`` counts the batches it has sampled."""

    def __init__(self, evd, device):
        self.evd = evd
        self.device = torch.device(device)
        self.runs = 0

    @torch.inference_mode()
    def run(self, node_mask, generator: torch.Generator, num_timesteps: Optional[int] = None,
            fix_noise: bool = False, context=None) -> np.ndarray:
        """Sample xh ``[B, N, 3+F]`` on the data scale (numpy, float32);
        ``context [B, N, C]`` for a property-conditioned model."""
        evd = self.evd
        T_s = evd.T if num_timesteps is None else int(num_timesteps)
        node_mask = torch.as_tensor(np.asarray(node_mask), dtype=torch.float32, device=self.device)
        if context is not None:
            context = torch.as_tensor(np.asarray(context), dtype=torch.float32, device=self.device)
        z = evd.init_sample_noise(node_mask, generator, fix_noise)
        s_values = np.arange(T_s - 1, -1, -1, dtype=np.float32)
        z = evd.reverse_segment(z, s_values / T_s, (s_values + 1) / T_s, node_mask,
                                generator, fix_noise, context=context)
        xh = evd.decode_sample(z, node_mask, generator, fix_noise, context=context)
        self.runs += 1
        return xh.cpu().numpy()


def make_node_mask(num_nodes: Sequence[int], pad_to: Optional[int] = None) -> np.ndarray:
    num_nodes = np.asarray(num_nodes)
    n = int(pad_to if pad_to is not None else num_nodes.max())
    return (np.arange(n)[None, :] < num_nodes[:, None]).astype(np.float32)


def select_bucket(n: int, bucket_sizes: Optional[Sequence[int]] = None, pad_to_multiple: int = 1) -> int:
    """Smallest configured bucket >= n, else n rounded up to ``pad_to_multiple``."""
    if bucket_sizes:
        for b in sorted(bucket_sizes):
            if n <= b:
                return int(b)
    return int(-(-n // pad_to_multiple) * pad_to_multiple)


def sample_molecules(
    sampler: SegmentedSampler,
    generator: torch.Generator,
    num_samples: int,
    nodes_dist: NumNodesDistribution,
    rng: np.random.Generator,
    batch_size: int = 100,
    pad_to: Optional[int] = None,
    num_timesteps: Optional[int] = None,
    props_distr=None,
    bucket_sizes: Optional[Sequence[int]] = None,
    pad_to_multiple: int = 2,
    sort_sizes: bool = True,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Sample in batches -> ``(xh [M, N, .], node_mask [M, N], num_nodes [M])``.

    All sizes are drawn up front; by default they are sorted descending and
    each batch is padded only to its own bucket (its largest size rounded up
    to ``pad_to_multiple``, or the ``bucket_sizes`` ladder, never past the
    dataset's largest molecule).  ``pad_to`` pins one padded size for every
    batch and keeps the drawn order.  A conditioned model's contexts come
    from ``props_distr`` (one ``sample_batch`` per batch from ``rng``, after
    the sizes)."""
    sizes_all = nodes_dist.sample(num_samples, rng)
    if pad_to is None and sort_sizes:
        sizes_all = np.sort(sizes_all)[::-1]
    xs, masks, sizes = [], [], []
    for start in range(0, num_samples, batch_size):
        num_nodes = sizes_all[start: start + batch_size]
        if pad_to is not None:
            n_pad = pad_to
        else:
            n_pad = select_bucket(int(num_nodes.max()), bucket_sizes, pad_to_multiple)
            n_pad = min(n_pad, max(int(nodes_dist.max_n), int(num_nodes.max())))
        node_mask = make_node_mask(num_nodes, n_pad)
        context = None
        if props_distr is not None:
            context = broadcast_context(props_distr.sample_batch(num_nodes, rng), node_mask)
        xs.append(sampler.run(node_mask, generator, num_timesteps=num_timesteps, context=context))
        masks.append(node_mask)
        sizes.append(num_nodes)
    n_max = max(x.shape[1] for x in xs)

    def pad_n(a):
        return np.pad(a, [(0, 0), (0, n_max - a.shape[1])] + [(0, 0)] * (a.ndim - 2))

    return (np.concatenate([pad_n(x) for x in xs]), np.concatenate([pad_n(m) for m in masks]),
            np.concatenate(sizes))


def analyze_samples(xh: np.ndarray, node_mask: np.ndarray, dataset_info: Dict[str, Any],
                    include_charges: bool = True, molecular_metrics=None) -> Dict[str, float]:
    """Molecule/atom stability and the atom-type KL of sampled molecules;
    validity, uniqueness and novelty when an RDKit metrics object
    (``chem.rdkit_bridge.build_molecular_metrics``) is given.
    ``include_charges`` is accepted for the JAX package's signature: the
    metrics read positions and atom types only."""
    dataset_info = ensure_bond_tables(dataset_info)
    k = len(dataset_info["atom_decoder"])
    x = xh[..., :3]
    atom_types = xh[..., 3: 3 + k].argmax(-1)
    mol_stable, stable_atoms, num_atoms = batch_molecular_stability(x, atom_types, node_mask, dataset_info)
    type_dist = CategoricalDistribution(dataset_info["atom_types"], dataset_info["atom_encoder"])
    metrics = {
        "mol_stable": float(mol_stable.mean()),
        "atm_stable": float(stable_atoms.sum() / max(num_atoms.sum(), 1)),
        "kl_div_atom_types": type_dist.kl_divergence(atom_types[node_mask > 0].astype(int).tolist()),
    }
    if molecular_metrics is not None:
        mols = [(x[i][node_mask[i] > 0], atom_types[i][node_mask[i] > 0]) for i in range(len(x))]
        validity, uniqueness, novelty = molecular_metrics.evaluate(mols)[:3]
        metrics.update(validity=validity, uniqueness=uniqueness, novelty=novelty)
    return metrics
