"""Node-count and atom-type distributions (host-side numpy).

Copy of ``NumNodesDistribution`` and ``CategoricalDistribution`` from
``bio_diffusion_tpu/models/distributions.py`` (which imports jax through its
package).  Draws take a ``np.random.Generator``.
"""

from __future__ import annotations

from typing import Dict, List

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
