"""The one traffic generator: it reads a traffic file (``traffic/<name>.json``)
and a frozen size histogram (``histograms/<name>.json``) and makes a run's
inputs from its seed.

Every seed gets the same set of molecule sizes, fixed by the file's
``template_seed``: batches are drawn so that the padded shapes (sampler
batches) or buckets (training batches) come in their expected proportions
over the template, rounded by largest remainder.  The run's seed orders the
batches and the molecules in them and makes what is random: atom positions
(compact clusters on a jittered grid of ``spacing``), atom types (the histogram's
type frequencies) and every diffusion draw.  So two seeds run the same work
in another order.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

ROOT = Path(__file__).resolve().parent


def seed_sequence(seed: int, *key: int) -> np.random.SeedSequence:
    """A stream of its own for ``seed`` and ``key`` (any integer seed)."""
    return np.random.SeedSequence(int(seed) % (1 << 64), spawn_key=tuple(int(k) % (1 << 32) for k in key))


def rng_for(seed: int, *key: int) -> np.random.Generator:
    return np.random.default_rng(seed_sequence(seed, *key))


def torch_seed(seed: int, *key: int) -> int:
    """A 63-bit seed for a ``torch.Generator``."""
    return int(seed_sequence(seed, *key).generate_state(1, np.uint64)[0] >> np.uint64(1))


@dataclass
class Histogram:
    sizes: np.ndarray  # molecule sizes present
    prob: np.ndarray  # their probabilities
    atomic_nb: np.ndarray  # atomic numbers of the atom types
    type_prob: np.ndarray  # atom-type frequencies

    @classmethod
    def load(cls, name: str, root: Path = ROOT) -> "Histogram":
        data = json.loads((root / "histograms" / f"{name}.json").read_text())
        sizes = np.array(sorted(int(k) for k in data["n_nodes"]), dtype=np.int64)
        counts = np.array([data["n_nodes"][str(k)] for k in sizes], dtype=np.float64)
        types = np.asarray(data["atom_types"], dtype=np.float64)
        return cls(sizes, counts / counts.sum(), np.asarray(data["atomic_nb"], dtype=np.int64), types / types.sum())

    @property
    def max_n(self) -> int:
        return int(self.sizes.max())

    def max_cdf(self, n: int, batch: int) -> float:
        """P(the largest of ``batch`` draws is at most ``n``)."""
        return float(self.prob[self.sizes <= n].sum()) ** batch


def largest_remainder(probs: Sequence[float], total: int) -> List[int]:
    raw = np.asarray(probs, dtype=np.float64) * total
    counts = np.floor(raw).astype(int)
    for i in np.argsort(-(raw - counts), kind="stable")[: total - counts.sum()]:
        counts[i] += 1
    return counts.tolist()


def stratified_batches(hist: Histogram, batch: int, count: int, shape_of, shapes: Sequence[int],
                       rng: np.random.Generator) -> List[np.ndarray]:
    """``count`` batches of ``batch`` sizes whose shapes (``shape_of(max
    size)``) come in their expected proportions, drawn by rejection."""
    edges = {}
    for n in hist.sizes:
        edges.setdefault(shape_of(int(n)), []).append(int(n))
    probs = []
    for s in shapes:
        top = max(edges.get(s, [0]))
        below = [n for n in hist.sizes if shape_of(int(n)) < s]
        probs.append(hist.max_cdf(top, batch) - (hist.max_cdf(max(below), batch) if below else 0.0)
                     if s in edges else 0.0)
    out: List[np.ndarray] = []
    for s, k in zip(shapes, largest_remainder(probs, count)):
        while k > 0:
            sizes = rng.choice(hist.sizes, size=batch, p=hist.prob)
            if shape_of(int(sizes.max())) == s:
                out.append(sizes)
                k -= 1
    return out


# -- sampling ------------------------------------------------------------------------


@dataclass
class SampleTraffic:
    batches: List[np.ndarray]  # sizes of each batch, in the order the window takes them
    pads: List[int]  # each batch's padded size
    num_timesteps: int

    @property
    def shapes(self) -> List[int]:
        return sorted(set(self.pads))


def sample_traffic(spec: Dict, seed: int, root: Path = ROOT) -> SampleTraffic:
    """Sampler batches: the template's batches in the template's order, each
    batch's molecules in the seed's order; a batch is padded as the sampling
    entry pads it (its largest size rounded up to ``pad_to_multiple``, never
    past the dataset's largest molecule)."""
    hist = Histogram.load(spec["sizes"], root)
    mult = int(spec["pad_to_multiple"])

    def pad(n: int) -> int:
        return min(-(-n // mult) * mult, max(hist.max_n, n))

    shapes = sorted({pad(int(n)) for n in hist.sizes})
    template = stratified_batches(hist, int(spec["batch_size"]), int(spec["batches"]), pad, shapes,
                                  rng_for(spec["template_seed"]))
    order = rng_for(spec["template_seed"], 1).permutation(len(template))
    rng = rng_for(seed, 10)
    batches = [rng.permutation(template[i]) for i in order]
    return SampleTraffic(batches, [pad(int(b.max())) for b in batches], int(spec["num_timesteps"]))


# -- training ------------------------------------------------------------------------


@dataclass
class TrainTraffic:
    positions: np.ndarray  # [M, Nmax, 3] float64, padded rows 0
    charges: np.ndarray  # [M, Nmax] int64 atomic numbers, padded rows 0
    num_atoms: np.ndarray  # [M]
    batch_size: int
    pads: List[int]  # each batch's padded size, in epoch order
    prefix: int  # the first batches: one of each padded size (at least 3)
    atomic_nb: np.ndarray

    @property
    def num_batches(self) -> int:
        return len(self.pads)

    def batch_rows(self, k: int) -> slice:
        return slice(k * self.batch_size, (k + 1) * self.batch_size)


def clusters(sizes: np.ndarray, n_max: int, hist: Histogram, spacing: float, jitter: float,
             rng: np.random.Generator):
    """Compact clusters of atoms, centred, with atom types drawn from the
    histogram's frequencies -> (positions, charges).  A molecule of ``n``
    atoms takes the ``n`` points of a cubic grid of ``spacing`` whose
    squared distance from the grid's centre, plus a random term, is least;
    each point is jittered by ``jitter``.  So no two atoms are much closer
    than ``spacing``, as in a real molecule.  (Random-walk chains put atoms
    that are not neighbours 0.02-0.1 A apart in every batch of 64 GEOM
    sizes, where the directions between atoms are ill-conditioned.)"""
    m = len(sizes)
    side = int(np.ceil(n_max ** (1.0 / 3.0))) + 3
    axis = np.arange(side) - (side - 1) / 2.0
    grid = np.stack(np.meshgrid(axis, axis, axis, indexing="ij"), -1).reshape(-1, 3)
    score = (grid ** 2).sum(-1)[None, :] + rng.uniform(0.0, 4.0 * side, size=(m, len(grid)))
    pos = grid[np.argsort(score, axis=1)[:, :n_max]] * spacing + rng.normal(scale=jitter, size=(m, n_max, 3))
    mask = np.arange(n_max)[None, :] < sizes[:, None]
    pos *= mask[..., None]
    pos -= (pos.sum(axis=1) / sizes[:, None])[:, None, :] * mask[..., None]
    types = hist.atomic_nb[rng.choice(len(hist.atomic_nb), size=(m, n_max), p=hist.type_prob)]
    return pos, np.where(mask, types, 0).astype(np.int64)


def train_traffic(spec: Dict, seed: int, root: Path = ROOT) -> TrainTraffic:
    """One epoch of training batches: each batch padded by the Trainer to the
    dataset's width (``buckets`` null) or to its bucket.  The epoch starts
    with one batch of each padded size (largest first, so that the steps the
    reference follows take the largest; at least 3 batches), the warm-up;
    the rest follow in the seed's order."""
    hist = Histogram.load(spec["sizes"], root)
    b = int(spec["batch_size"])
    buckets = spec.get("buckets")

    def pad(n: int) -> int:
        if not buckets:
            return hist.max_n
        return next((x for x in sorted(buckets) if n <= x), max(buckets))

    shapes = sorted({pad(int(n)) for n in hist.sizes})
    template = stratified_batches(hist, b, int(spec["epoch_batches"]), pad, shapes, rng_for(spec["template_seed"]))
    pads = [pad(int(t.max())) for t in template]
    first = [pads.index(s) for s in sorted(set(pads), reverse=True)]
    prefix = list(first) + [i for i in range(len(template)) if i not in first][: max(0, 3 - len(first))]
    rng = rng_for(seed, 20)
    rest = [i for i in range(len(template)) if i not in prefix]
    order = prefix + [rest[i] for i in rng.permutation(len(rest))]
    sizes = np.concatenate([rng.permutation(template[i]) for i in order]).astype(np.int64)
    n_max = hist.max_n if not buckets else int(sizes.max())
    pos, charges = clusters(sizes, n_max, hist, float(spec["spacing"]), float(spec["jitter"]), rng)
    return TrainTraffic(pos, charges, sizes, b, [pads[i] for i in order], len(prefix), hist.atomic_nb)


def sample_draws_shape(num_timesteps: int, batch: int, pad: int, features: int) -> tuple:
    """The raw draws of one sampler batch: the prior, one a reverse step, the decode."""
    return (num_timesteps + 2, batch, pad, features)


def selected(values: Sequence, k: int, rng: np.random.Generator, must: Optional[int] = None) -> List[int]:
    """``k`` indices of ``values`` drawn by ``rng`` without replacement, ``must`` among them."""
    idx = list(rng.choice(len(values), size=min(k, len(values)), replace=False))
    if must is not None and must not in idx:
        idx[-1] = must
    return sorted(int(i) for i in idx)
