"""The traffic generator: a seed reproduces its inputs, and every seed gets the same sizes."""

import collections

import numpy as np
import pytest

from gcdm_bench import traffic
from gcdm_bench.harness import read_json

SEEDS = [0, 2 ** 31 + 5, 2 ** 40 + 3]


@pytest.mark.parametrize("name", ["geom_train_b64", "qm9_train_b64"])
def test_a_seed_reproduces_its_training_data(name):
    spec = read_json("traffic", name)
    a, b = traffic.train_traffic(spec, SEEDS[1]), traffic.train_traffic(spec, SEEDS[1])
    assert np.array_equal(a.num_atoms, b.num_atoms) and np.array_equal(a.positions, b.positions)
    assert np.array_equal(a.charges, b.charges) and a.pads == b.pads
    c = traffic.train_traffic(spec, SEEDS[2])
    assert not np.array_equal(a.positions, c.positions)
    assert sorted(a.num_atoms) == sorted(c.num_atoms)
    assert collections.Counter(a.pads) == collections.Counter(c.pads)
    assert a.pads[: a.prefix] == c.pads[: c.prefix] and a.prefix >= 3
    assert set(a.pads[: a.prefix]) == set(a.pads)


def test_a_seed_reproduces_its_sampler_batches():
    spec = read_json("traffic", "qm9_sample_b250")
    runs = [traffic.sample_traffic(spec, s) for s in SEEDS + [SEEDS[0]]]
    assert all(np.array_equal(x, y) for x, y in zip(runs[0].batches, runs[-1].batches))
    for r in runs[1:]:
        assert r.pads == runs[0].pads
        assert all(sorted(x) == sorted(y) for x, y in zip(r.batches, runs[0].batches))
    assert all(len(b) == 250 for b in runs[0].batches)
    assert set(runs[0].pads) == {26, 28, 29}


def test_the_buckets_come_in_their_expected_shares():
    spec = read_json("traffic", "geom_train_b64")
    tr = traffic.train_traffic(spec, 1)
    assert collections.Counter(tr.pads) == {96: 27, 64: 2, 128: 2, 192: 1}
    # the epoch's first steps, which the reference follows, take the largest bucket
    assert tr.pads[:4] == [192, 128, 96, 64]


def test_large_and_negative_seeds_are_taken():
    for s in (2 ** 63 + 1, -5):
        assert 0 <= traffic.torch_seed(s, 1) < 2 ** 63


@pytest.mark.parametrize("name", ["geom_train_b64", "qm9_train_b64"])
def test_no_two_atoms_are_closer_than_a_bond(name):
    spec = read_json("traffic", name)
    tr = traffic.train_traffic(spec, SEEDS[1])
    for j in range(0, len(tr.num_atoms), 7):
        p = tr.positions[j, : tr.num_atoms[j]]
        d = np.linalg.norm(p[:, None] - p[None], axis=-1) + np.eye(len(p)) * 1e9
        assert d.min() > 0.9 * spec["spacing"] - 4 * spec["jitter"]
        assert np.abs(p.mean(0)).max() < 1e-9
