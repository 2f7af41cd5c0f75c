"""Node-count and atom-type distributions used by sampling (host-side numpy).

Copy of the sampling half of ``bio_diffusion_tpu/models/distributions.py``
(which imports jax through its package).  Draws take a
``np.random.Generator``.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


class NumNodesDistribution:
    """Categorical over molecule sizes from a dataset histogram."""

    def __init__(self, histogram: Dict[int, int]):
        nodes = np.array(sorted(int(k) for k in histogram), dtype=np.int64)
        counts = np.array([histogram[int(n)] for n in nodes], dtype=np.float64)
        self.num_nodes = nodes
        self.prob = counts / counts.sum()
        self.max_n = int(nodes.max())

    def sample(self, n_samples: int, rng: np.random.Generator) -> np.ndarray:
        idx = rng.choice(len(self.num_nodes), size=n_samples, p=self.prob)
        return self.num_nodes[idx]


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
