"""Port parity: the packed message layer (packing, plain version, kernel wrapper).

The port's weight packing and plain version are held against the JAX
package's ``pack_gcp1_weights``/chain packing, its Pallas kernel in interpret
mode (``fused_message_layer(..., interpret=True)``) and its plain math
``message_layer_reference``, all float32 at atol 1e-5.  The CUDA kernel is
held against the plain version in ``test_torch_kernel.py`` (needs a card).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bio_diffusion_tpu.models.gcpnet_fast import message_layer_reference, pack_chain_weights_jnp
from bio_diffusion_tpu.ops.pallas.gcp_kernel import fused_message_layer as jax_fused_message_layer
from bio_diffusion_tpu.ops.pallas.gcp_kernel import pack_gcp1_weights as jax_pack_gcp1_weights
from bio_diffusion_torch.ops import message_layer as ml
from test_torch_common import build_jax_and_port

ATOL = 1e-5
S, V, SE, VE = 16, 4, 8, 2


@pytest.fixture(scope="module")
def packed():
    """Layer 0 weights packed by both sides from the same JAX params."""
    cfgs, _, dyn_params, _, _, evd = build_jax_and_port()
    mp = dyn_params["params"]["interaction_layers_0"]["interaction"]
    g1_j = {k: v for k, v in jax_pack_gcp1_weights(mp["message_fusion_0"], S, V, VE).items()
            if isinstance(v, np.ndarray)}
    chain_j = pack_chain_weights_jnp(mp, cfgs[2].mp_cfg.num_message_layers, jnp.float32)
    port_mp = evd.dynamics_network.interaction_layers[0].interaction
    g1_t = ml.pack_gcp1_weights(port_mp.message_fusion[0], S, V, VE)
    chain_t = ml.pack_chain_weights(port_mp.message_fusion[1:], port_mp.scalar_message_attention[0])
    return g1_j, chain_j, g1_t, chain_t


def layer_inputs(b, n, padded_rows, seed):
    """Numpy-seeded s_node, v_node and epack [B, N*N, Se+3Ve+10] (unpadded)."""
    rng = np.random.default_rng(seed)
    mask = np.ones((b, n), np.float32)
    for row, count in padded_rows:
        mask[row, n - count:] = 0
    em = (mask[:, :, None] * mask[:, None, :]).reshape(b, n * n, 1)
    epack = np.concatenate([
        rng.normal(size=(b, n * n, SE)), rng.normal(size=(b, n * n, 3 * VE)),
        rng.uniform(-1, 1, size=(b, n * n, 9)), em,
    ], axis=-1).astype(np.float32) * em
    s = (rng.normal(size=(b, n, S)) * mask[..., None]).astype(np.float32)
    v = (rng.normal(size=(b, n, 3 * V)) * mask[..., None]).astype(np.float32)
    return s, v, epack


def as_torch(g1, chain):
    return ({k: torch.from_numpy(np.array(v)) for k, v in g1.items()},
            tuple(torch.from_numpy(np.array(c)) for c in chain))


def test_packing_matches_jax(packed):
    g1_j, chain_j, g1_t, chain_t = packed
    assert set(g1_j) == set(g1_t)
    for k in g1_j:
        np.testing.assert_allclose(g1_t[k].numpy(), g1_j[k], atol=1e-7, rtol=0, err_msg=k)
    assert len(chain_j) == len(chain_t)
    for a, b in zip(chain_t, chain_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-7, rtol=0)


def test_plain_matches_pallas_interpret(packed):
    g1_j, chain_j, g1_t, chain_t = packed
    s, v, epack = layer_inputs(2, 5, [(1, 1)], seed=1)
    # the TPU layout pads the packed edge tensor to 128 columns
    ep_j = np.pad(epack, ((0, 0), (0, 0), (0, 128 - epack.shape[-1])))
    s_j, v_j = jax_fused_message_layer(
        jnp.asarray(s), jnp.asarray(v), jnp.asarray(ep_j),
        {k: jnp.asarray(x) for k, x in g1_j.items()}, chain_j, ve_dim=VE, interpret=True)
    s_t, v_t = ml.message_layer_plain(torch.from_numpy(s), torch.from_numpy(v),
                                      torch.from_numpy(epack), g1_t, chain_t, ve_dim=VE)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), atol=ATOL, rtol=0)
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), atol=ATOL, rtol=0)


def test_plain_matches_reference(packed):
    g1_j, chain_j, g1_t, chain_t = packed
    s, v, epack = layer_inputs(3, 7, [(2, 1)], seed=2)
    s_j, v_j = message_layer_reference(
        jnp.asarray(s), jnp.asarray(v), jnp.asarray(epack),
        {k: jnp.asarray(x) for k, x in g1_j.items()}, chain_j, ve_dim=VE)
    # the port's plain version on the port's own packing and on JAX's
    for g1, chain in ((g1_t, chain_t), as_torch(g1_j, chain_j)):
        s_t, v_t = ml.message_layer_plain(torch.from_numpy(s), torch.from_numpy(v),
                                          torch.from_numpy(epack), g1, chain, ve_dim=VE)
        np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), atol=ATOL, rtol=0)
        np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), atol=ATOL, rtol=0)
    # padded source rows aggregate nothing
    assert np.all(s_t.numpy()[2, -1] == 0) and np.all(v_t.numpy()[2, -1] == 0)


def test_wrapper_takes_plain_version_on_cpu(packed):
    _, _, g1_t, chain_t = packed
    s, v, epack = layer_inputs(2, 4, [], seed=3)
    args = (torch.from_numpy(s), torch.from_numpy(v), torch.from_numpy(epack), g1_t, chain_t)
    before = ml.launch_counts["message_layer"]
    out = ml.fused_message_layer(*args, ve_dim=VE)
    ref = ml.message_layer_plain(*args, ve_dim=VE)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    assert ml.launch_counts["message_layer"] == before  # no kernel launched on the CPU
    with pytest.raises(RuntimeError, match="no message-layer implementation"):
        ml.fused_message_layer(*(a.to("meta") for a in args[:3]), g1_t, chain_t, ve_dim=VE)
