"""Node-count, property and atom-type distributions (host-side numpy).

Copy of ``NumNodesDistribution``, ``PropertiesDistribution``,
``CategoricalDistribution`` and ``compute_mean_mad`` from
``bio_diffusion_tpu/models/distributions.py`` (which imports jax through its
package), and ``property_normalizers``, the conditioning normalizers and
property histograms the Trainer and the conditional CLIs share.  Draws take a ``np.random.Generator``; the same generator state
gives the same draws as the JAX package's.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np


class NumNodesDistribution:
    """Categorical over molecule sizes from a dataset histogram.

    ``log_prob_table`` is a float32 array indexed by n (log p(N) for the
    training objective), ``log(eps)`` at sizes the histogram lacks."""

    def __init__(self, histogram: Dict[int, int], eps: float = 1e-30):
        nodes = np.array(sorted(int(k) for k in histogram), dtype=np.int64)
        counts = np.array([histogram[int(n)] for n in nodes], dtype=np.float64)
        self.num_nodes = nodes
        self.prob = counts / counts.sum()
        self.max_n = int(nodes.max())
        table = np.full(self.max_n + 1, eps, dtype=np.float64)
        table[nodes] = self.prob + eps
        self.log_prob_table = np.log(table).astype(np.float32)

    def sample(self, n_samples: int, rng: np.random.Generator) -> np.ndarray:
        idx = rng.choice(len(self.num_nodes), size=n_samples, p=self.prob)
        return self.num_nodes[idx]

    def log_prob(self, batch_n_nodes: np.ndarray) -> np.ndarray:
        return self.log_prob_table[np.asarray(batch_n_nodes, dtype=np.int64)]


class PropertiesDistribution:
    """Per-node-count histograms of conditioning property values: 1000 bins
    per molecule size; a draw picks a bin, then a uniform value inside it,
    normalized by ``normalizer`` (``{prop: {"mean", "mad"}}``)."""

    def __init__(self, num_atoms: np.ndarray, properties: Dict[str, np.ndarray], num_bins: int = 1000,
                 normalizer: Optional[Dict[str, Dict[str, float]]] = None):
        self.properties = list(properties.keys())
        self.num_bins = num_bins
        self.normalizer = normalizer
        self.distributions: Dict[str, Dict[int, Dict[str, np.ndarray]]] = {}
        num_atoms = np.asarray(num_atoms)
        for prop, values in properties.items():
            values = np.asarray(values, dtype=np.float64)
            self.distributions[prop] = {}
            for n in range(int(num_atoms.min()), int(num_atoms.max()) + 1):
                vals = values[num_atoms == n]
                if len(vals) == 0:
                    continue
                probs, params = self._probs_given_nodes(vals)
                self.distributions[prop][n] = {"probs": probs, "params": params}

    def _probs_given_nodes(self, values: np.ndarray, eps: float = 1e-12):
        prop_min, prop_max = values.min(), values.max()
        prop_range = prop_max - prop_min + eps
        idx = ((values - prop_min) / prop_range * self.num_bins).astype(np.int64)
        idx = np.minimum(idx, self.num_bins - 1)
        hist = np.bincount(idx, minlength=self.num_bins).astype(np.float64)
        return hist / hist.sum(), (prop_min, prop_max)

    def normalize(self, value: np.ndarray, prop: str) -> np.ndarray:
        if self.normalizer is None:
            raise ValueError("PropertiesDistribution has no normalizer")
        return (value - self.normalizer[prop]["mean"]) / self.normalizer[prop]["mad"]

    def sample(self, num_nodes: int, rng: np.random.Generator) -> np.ndarray:
        """One normalized value per property for a molecule of ``num_nodes`` -> ``[C]``."""
        vals = []
        for prop in self.properties:
            dist = self.distributions[prop][int(num_nodes)]
            idx = rng.choice(self.num_bins, p=dist["probs"])
            prop_min, prop_max = dist["params"]
            prop_range = prop_max - prop_min
            left = idx / self.num_bins * prop_range + prop_min
            right = (idx + 1) / self.num_bins * prop_range + prop_min
            vals.append(self.normalize(rng.uniform(left, right), prop))
        return np.array(vals, dtype=np.float32)

    def sample_batch(self, num_nodes: Sequence[int], rng: np.random.Generator) -> np.ndarray:
        """``[B, C]``: one :meth:`sample` per molecule, in order."""
        return np.stack([self.sample(int(n), rng) for n in num_nodes], axis=0)


class CategoricalDistribution:
    """Atom-type marginal; KL(data || samples) diagnostic."""

    EPS = 1e-10

    def __init__(self, histogram_dict: Dict[int, int], mapping: Dict[str, int]):
        histogram = np.zeros(len(mapping))
        for k, v in histogram_dict.items():
            histogram[int(k)] = v
        self.p = histogram / histogram.sum()
        self.mapping = mapping

    def kl_divergence(self, other_samples: List[int]) -> float:
        sample_histogram = np.zeros(len(self.mapping))
        for x in other_samples:
            sample_histogram[int(x)] += 1
        q = sample_histogram / max(sample_histogram.sum(), 1)
        return float(-np.sum(self.p * np.log(q / self.p + self.EPS)))


def compute_mean_mad(values: np.ndarray) -> Dict[str, float]:
    """Mean and mean absolute deviation of one property column: its normalizer."""
    values = np.asarray(values, dtype=np.float64)
    mean = values.mean()
    return {"mean": float(mean), "mad": float(np.abs(values - mean).mean())}


def property_normalizers(datasets: Dict[str, Any], conditioning, dataset_name: str):
    """``({prop: {"mean", "mad"}}, PropertiesDistribution)`` of the
    conditioning properties, or ``(None, None)`` without any: the normalizers
    from the valid split for ``QM9_second_half`` and the train split
    otherwise, the per-size histograms from the train split."""
    if not conditioning:
        return None, None
    split = "valid" if dataset_name == "QM9_second_half" else "train"
    norms = {p: compute_mean_mad(datasets[split].property_values(p)) for p in conditioning}
    train = datasets["train"]
    distr = PropertiesDistribution(train.data["num_atoms"], {p: train.property_values(p) for p in conditioning},
                                   normalizer=norms)
    return norms, distr
