"""Batch samplers: node-budget packing.

Copy of ``node_budget_batches`` of ``bio_diffusion_tpu/data/samplers.py``,
the counterpart of the reference's ``BatchSampler``
(src/datamodules/components/sampler.py): pack molecule indices into batches
bounded by a total-node budget.  With dense padding the budget bounds the
padded batch area (B x N_bucket), keeping the work of every batch about the
same.  The multi-host ``shard_indices`` waits for multi-GPU training
(ROADMAP A12).
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence

import numpy as np

from bio_diffusion_torch.data.batch import select_bucket


def node_budget_batches(
    num_atoms: np.ndarray,
    max_nodes_per_batch: int,
    rng: Optional[np.random.Generator] = None,
    shuffle: bool = True,
    bucket_sizes: Optional[Sequence[int]] = None,
) -> Iterator[np.ndarray]:
    """Yield index batches whose padded node area stays within budget.

    With ``bucket_sizes``, the cost of a batch is B * bucket(N_max) — the
    padded work — otherwise B * max(num_atoms in batch).
    """
    m = len(num_atoms)
    order = np.arange(m)
    if shuffle:
        assert rng is not None
        rng.shuffle(order)

    batch: List[int] = []
    cur_max = 0
    for idx in order:
        n = int(num_atoms[idx])
        new_max = max(cur_max, n)
        padded = select_bucket(new_max, bucket_sizes) if bucket_sizes else new_max
        if batch and (len(batch) + 1) * padded > max_nodes_per_batch:
            yield np.asarray(batch)
            batch, cur_max = [], 0
        batch.append(int(idx))
        cur_max = max(cur_max, n)
    if batch:
        yield np.asarray(batch)
