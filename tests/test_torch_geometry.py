"""Port parity: bio_diffusion_torch.ops.geometry against bio_diffusion_tpu.ops.geometry.

Masked float32 batches with padded rows; tolerance atol 1e-6 (same float32
formulas, only the summation order may differ).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bio_diffusion_tpu.ops import geometry as jg
from bio_diffusion_torch.ops import geometry as tg

ATOL = 1e-6


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(0)
    b, n = 3, 6
    mask = np.ones((b, n), np.float32)
    mask[1, 4:] = 0
    mask[2, 2:] = 0
    x = (rng.normal(size=(b, n, 3)) * mask[..., None]).astype(np.float32)
    x[0, 3] = x[0, 2]  # a coincident pair: zero difference vector
    return x, mask


def close(torch_out, jax_out, atol=ATOL):
    np.testing.assert_allclose(torch_out.numpy(), np.asarray(jax_out), atol=atol, rtol=0)


def test_safe_norm_and_normalize(batch):
    x, _ = batch
    close(tg.safe_norm(torch.from_numpy(x)), jg.safe_norm(jnp.asarray(x)))
    close(tg.safe_normalize(torch.from_numpy(x)), jg.safe_normalize(jnp.asarray(x)))


def test_build_edge_mask_and_centralize(batch):
    x, mask = batch
    tm, jm = torch.from_numpy(mask), jnp.asarray(mask)
    close(tg.build_edge_mask(tm), jg.build_edge_mask(jm))
    tc, tx = tg.centralize(torch.from_numpy(x), tm)
    jc, jx = jg.centralize(jnp.asarray(x), jm)
    close(tc, jc)
    close(tx, jx)
    assert np.all(tx.numpy()[mask == 0] == 0)


@pytest.mark.parametrize("norm_x_diff", [True, False])
def test_localize_and_mean_frames(batch, norm_x_diff):
    x, mask = batch
    tm, jm = torch.from_numpy(mask), jnp.asarray(mask)
    _, xc = jg.centralize(jnp.asarray(x), jm)
    em_t, em_j = tg.build_edge_mask(tm), jg.build_edge_mask(jm)
    f_t = tg.localize(torch.from_numpy(np.array(xc)), em_t, norm_x_diff=norm_x_diff)
    f_j = jg.localize(xc, em_j, norm_x_diff=norm_x_diff)
    close(f_t, f_j)
    close(tg.node_mean_frames(f_t, em_t), jg.node_mean_frames(f_j, em_j))


def test_orientations_and_edge_features(batch):
    x, mask = batch
    tm, jm = torch.from_numpy(mask), jnp.asarray(mask)
    close(tg.orientations(torch.from_numpy(x), tm), jg.orientations(jnp.asarray(x), jm))
    ts, tv = tg.edge_features(torch.from_numpy(x), tg.build_edge_mask(tm))
    js, jv = jg.edge_features(jnp.asarray(x), jg.build_edge_mask(jm))
    close(ts, js)
    close(tv, jv)


def test_masked_sum_and_frame_projections(batch):
    """``masked_sum``, ``scalarize`` and ``vectorize`` on per-edge frames."""
    x, mask = batch
    em = jg.build_edge_mask(jnp.asarray(mask), include_self_loops=True)
    frames = jg.localize(jnp.asarray(x), em)
    rng = np.random.default_rng(1)
    v = rng.normal(size=frames.shape[:-2] + (4, 3)).astype(np.float32)
    gate = rng.normal(size=frames.shape[:-2] + (12,)).astype(np.float32)
    f_t, em_t = torch.from_numpy(np.asarray(frames)), torch.from_numpy(np.asarray(em))
    close(tg.scalarize(torch.from_numpy(v), f_t), jg.scalarize(jnp.asarray(v), frames))
    close(tg.vectorize(torch.from_numpy(gate), f_t), jg.vectorize(jnp.asarray(gate), frames))
    close(tg.masked_sum(torch.from_numpy(v), em_t, dim=-3), jg.masked_sum(jnp.asarray(v), em, axis=-3))
