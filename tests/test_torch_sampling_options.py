"""Three options of the JAX package's sampling functions, in the port.

* ``norm_with_original_timesteps``: the sampler (``SegmentedSampler.run``)
  with JAX's draws against JAX's ``SegmentedSampler.run`` at T_s = 5 of
  T = 10 (positions atol 1e-4, tests/test_torch_diffusion.py; types
  identical), and ``mol_gen_optimize`` against JAX's on the conditional
  model (atol 1e-4, as ``test_mol_gen_optimize_matches_jax``), each also
  differing from the run without it; ``mol_gen_optimize_rows`` on one
  device equals the EVD method bit for bit.
* ``sample_molecules(context_fn=)``: both functions around a stand-in
  sampler (the same sizes from the same numpy seed, each batch's mask and
  ``context_fn``'s context handed to the sampler, the padded outputs),
  exactly.
* ``data/batch.py::collate_dense``: ragged molecules with and without
  charges and contexts, exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bio_diffusion_tpu.models.diffusion import EquivariantVariationalDiffusion as JaxEVD
from bio_diffusion_tpu.ops.geometry import centralize as jax_centralize
from test_torch_conditioning import raw_noise
from test_torch_conditioning import setup as conditional_setup  # noqa: F401 — a fixture
from test_torch_parallel import jax_sampler_draws, sampler_models, sizes_mask  # noqa: F401 — a fixture

ATOL = 1e-4
T_S = 5  # of the tiny model's T = 10


@pytest.mark.parametrize("norm", [True, False])
def test_sampler_norm_with_original_timesteps_matches_jax(sampler_models, norm):
    """T_s = 5 steps at s / T (the model's last 5 of 10) or at s / T_s, with
    JAX's draws, against JAX's sampler; the two differ."""
    from bio_diffusion_tpu.train.sampling import SegmentedSampler as JaxSampler
    from bio_diffusion_torch.train.sampling import SegmentedSampler

    jax_evd, params, evd = sampler_models
    mask = sizes_mask(4)
    key = jax.random.PRNGKey(5)
    ref = JaxSampler(jax_evd, params).run(key, jnp.asarray(mask), num_timesteps=T_S,
                                          norm_with_original_timesteps=norm)
    sampler = SegmentedSampler(evd, devices=["cpu"])
    noises = jax_sampler_draws(key, 4, 7, T_S)
    ours = sampler.run(mask, None, num_timesteps=T_S, noises=noises, norm_with_original_timesteps=norm)
    np.testing.assert_allclose(ours[..., :3], ref[..., :3], rtol=0, atol=ATOL)
    np.testing.assert_array_equal(ours[..., 3:], ref[..., 3:])
    other = sampler.run(mask, None, num_timesteps=T_S, noises=noises, norm_with_original_timesteps=not norm)
    assert np.abs(other[..., :3] - ours[..., :3]).max() > 100 * ATOL


def test_mol_gen_optimize_norm_with_original_timesteps_matches_jax(conditional_setup):  # noqa: F811
    """The round trip's last 5 steps at s / T against JAX's
    ``mol_gen_optimize(norm_with_original_timesteps=True)`` with its draws;
    ``mol_gen_optimize_rows`` on one device gives the same bit for bit."""
    from bio_diffusion_torch.parallel.distributed import Replicas
    from bio_diffusion_torch.train.sampling import mol_gen_optimize_rows

    _, _, batch, batch_j, _, evd_j, params, evd, _ = conditional_setup
    b, n = batch.node_mask.shape
    _, x_j = jax_centralize(batch_j.x, batch_j.node_mask)
    key = jax.random.PRNGKey(17)
    ref = np.asarray(evd_j.apply(params, key, x_j, batch_j.one_hot, batch_j.node_mask, T_S, batch_j.context,
                                 norm_with_original_timesteps=True, method=JaxEVD.mol_gen_optimize))
    noises, carry = [], key
    for _ in range(T_S):
        carry, k1, _ = jax.random.split(carry, 3)
        noises.append(raw_noise(k1, b, n))
    _, k_final = jax.random.split(carry)
    noises.append(raw_noise(k_final, b, n))
    args = (torch.from_numpy(np.array(x_j)), torch.from_numpy(batch.one_hot), torch.from_numpy(batch.node_mask),
            T_S, torch.from_numpy(batch.context))
    with torch.inference_mode():
        ours = evd.mol_gen_optimize(*args, noises=noises, norm_with_original_timesteps=True).numpy()
        plain = evd.mol_gen_optimize(*args, noises=noises).numpy()
        rows = mol_gen_optimize_rows(Replicas(evd), *args, torch.Generator().manual_seed(2),
                                     norm_with_original_timesteps=True).numpy()
        direct = evd.mol_gen_optimize(*args, generator=torch.Generator().manual_seed(2),
                                      norm_with_original_timesteps=True).numpy()
    np.testing.assert_allclose(ours[..., :3], ref[..., :3], atol=ATOL, rtol=0)
    np.testing.assert_array_equal(ours[..., 3:], ref[..., 3:])
    assert np.abs(plain[..., :3] - ours[..., :3]).max() > 100 * ATOL
    np.testing.assert_array_equal(rows, direct)


class _JaxStandIn:
    """A sampler of JAX's ``run`` signature: records each call's mask and
    context, returns ``context + mask`` (numpy)."""

    def __init__(self):
        self.calls = []

    def run(self, key, node_mask, num_timesteps=None, context=None):
        self.calls.append((np.asarray(node_mask), np.asarray(context)))
        return np.asarray(context) + np.asarray(node_mask)[..., None]


class _PortStandIn(_JaxStandIn):
    def run(self, node_mask, generator, num_timesteps=None, context=None):
        return super().run(None, node_mask, num_timesteps, context)


def test_sample_molecules_context_fn_matches_jax():
    """``context_fn(num_nodes, node_mask)`` gives each batch's context, in
    both packages alike: the same sizes, masks, contexts and output."""
    from bio_diffusion_tpu.models.distributions import NumNodesDistribution as JaxNodes
    from bio_diffusion_tpu.train.sampling import sample_molecules as jax_sample_molecules
    from bio_diffusion_torch.models.distributions import NumNodesDistribution
    from bio_diffusion_torch.train.sampling import sample_molecules

    hist = {3: 5, 4: 2, 6: 7, 9: 1}

    def context_fn(num_nodes, node_mask):
        mask = np.asarray(node_mask, dtype=np.float32)
        return np.stack([mask * num_nodes[:, None], mask * 0.5], axis=-1).astype(np.float32)

    results = []
    for sampler, call, nodes in ((_PortStandIn(), lambda *a, **k: sample_molecules(*a, **k), NumNodesDistribution),
                                 (_JaxStandIn(), lambda s, g, *a, **k: jax_sample_molecules(
                                     s, jax.random.PRNGKey(0), *a, **k), JaxNodes)):
        out = call(sampler, None, 11, nodes(hist), np.random.default_rng(3), batch_size=4, context_fn=context_fn)
        results.append((out, sampler.calls))
    (ours, our_calls), (ref, ref_calls) = results
    assert len(our_calls) == len(ref_calls) == 3
    for (m1, c1), (m2, c2) in zip(our_calls, ref_calls):
        np.testing.assert_array_equal(m1, m2)
        np.testing.assert_array_equal(c1, c2)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("charges", [True, False])
@pytest.mark.parametrize("context", [True, False])
def test_collate_dense_matches_jax(charges, context):
    from bio_diffusion_tpu.data.batch import collate_dense as jax_collate_dense
    from bio_diffusion_torch.data.batch import collate_dense

    rng = np.random.default_rng(7)
    sizes = [3, 6, 1, 5]
    positions = [rng.normal(size=(n, 3)) for n in sizes]
    one_hot = [np.eye(4)[rng.integers(0, 4, n)] for n in sizes]
    kw = {"charges": [rng.integers(1, 9, n) for n in sizes] if charges else None,
          "context": rng.normal(size=(4, 2)) if context else None}
    ours, ref = collate_dense(positions, one_hot, pad_to=7, **kw), jax_collate_dense(positions, one_hot, pad_to=7, **kw)
    for field in ("x", "one_hot", "charges", "node_mask", "context"):
        a, b = getattr(ours, field), getattr(ref, field)
        if b is None:
            assert a is None, field
        else:
            assert a.dtype == np.float32 and a.shape == np.shape(b), field
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=field)
