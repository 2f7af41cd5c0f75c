"""Port parity: the flat-edge GCP2 chain and the unfused message-passing path.

* ``gcp2_chain_plain`` (and the wrapper ``fused_gcp2_chain`` on CPU tensors)
  against the JAX package's Pallas ``fused_gcp2_chain(..., interpret=True)``
  on the same numpy-seeded inputs and weights: E=70 with S=32, V=4, H=4, G=3
  (the case of ``tests/test_pallas_gcp.py``) and one case at QM9 width (S=256,
  V=32, H=8, G=3) with a small E; float32, atol 2e-5 (summation order, and
  the TPU kernel's tanh-form sigmoid against the port's exp form, an exact
  identity).
* ``message_passing_unfused`` on the tiny config (layer 0 of weights carried
  over by ``state_dict_from_jax_params``) against JAX
  ``_message_passing_fast`` with ``use_pallas=False`` and with
  ``use_pallas=True, interpret=True``; float32, atol 1e-5.  The same path
  against the port's own fused route (``message_layer_plain``).
* The wrapper's input checks.

The CUDA kernel is held against the plain version in ``test_torch_kernel.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bio_diffusion_tpu.models.gcpnet_fast import _message_passing_fast
from bio_diffusion_tpu.ops.pallas.gcp_kernel import fused_gcp2_chain as jax_fused_gcp2_chain
from bio_diffusion_torch.models.gcpnet import message_passing_unfused, stack_chain_weights
from bio_diffusion_torch.ops import message_layer as ml
from bio_diffusion_torch.ops.gcp2_chain import fused_gcp2_chain, gcp2_chain_plain
from test_torch_common import build_jax_and_port

S, V, SE, VE = 16, 4, 8, 2  # the tiny config of test_torch_common


def chain_inputs(e, s_dim, v_dim, h, g, seed):
    """Numpy-seeded s, v, frames_t and stacked chain weights, scaled by fan-in."""
    rng = np.random.default_rng(seed)

    def normal(*shape, fan_in=1):
        return (rng.normal(size=shape) / np.sqrt(fan_in)).astype(np.float32)

    return (normal(e, s_dim), normal(e, 3 * v_dim), rng.uniform(-1, 1, size=(e, 9)).astype(np.float32),
            normal(g, v_dim, h, fan_in=v_dim), normal(g, v_dim, 3, fan_in=v_dim),
            normal(g, s_dim + h + 9, s_dim, fan_in=s_dim + h + 9), normal(g, s_dim, fan_in=4),
            normal(g, h, v_dim, fan_in=h), normal(g, s_dim, v_dim, fan_in=s_dim), normal(g, v_dim, fan_in=4),
            normal(s_dim, 1, fan_in=s_dim), normal(1))


@pytest.mark.parametrize("e,s_dim,v_dim,h", [(70, 32, 4, 4), (37, 256, 32, 8)])
def test_chain_plain_matches_pallas_interpret(e, s_dim, v_dim, h):
    args = chain_inputs(e, s_dim, v_dim, h, 3, seed=e)
    s_j, v_j = jax_fused_gcp2_chain(*(jnp.asarray(a) for a in args), interpret=True)
    ts = [torch.from_numpy(a) for a in args]
    before = ml.launch_counts["gcp2_chain"]
    for fn in (gcp2_chain_plain, fused_gcp2_chain):
        s_t, v_t = fn(*ts)
        np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), atol=2e-5, rtol=0)
        np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), atol=2e-5, rtol=0)
    assert ml.launch_counts["gcp2_chain"] == before  # CPU tensors take the plain version


@pytest.fixture(scope="module")
def layer():
    """Layer 0 of the tiny model on both sides (JAX params carried over to the
    port), and numpy-seeded unfused inputs with a padded node."""
    _, _, dyn_params, _, _, evd = build_jax_and_port()
    mp_j = dyn_params["params"]["interaction_layers_0"]["interaction"]
    mp_t = evd.dynamics_network.interaction_layers[0].interaction
    b, n = 2, 5
    rng = np.random.default_rng(4)
    mask = np.ones((b, n), np.float32)
    mask[1, -1] = 0
    em = mask[:, :, None] * mask[:, None, :]
    inputs = (rng.normal(size=(b, n, S)), rng.normal(size=(b, n, 3, V)), rng.normal(size=(b, n, n, SE)),
              rng.normal(size=(b, n, n, 3, VE)), rng.uniform(-1, 1, size=(b * n * n, 9)), em)
    return mp_j, mp_t, [np.asarray(a, np.float32) for a in inputs]


@pytest.mark.parametrize("use_pallas", [False, True])
def test_unfused_matches_jax_message_passing(layer, use_pallas):
    mp_j, mp_t, inputs = layer
    s_j, v_j = _message_passing_fast(mp_j, *(jnp.asarray(a) for a in inputs), num_message_layers=4,
                                     use_pallas=use_pallas, interpret=True)
    s_t, v_t = message_passing_unfused(mp_t, *(torch.from_numpy(a) for a in inputs), use_kernel=False)
    assert s_t.shape == (2, 5, S) and v_t.shape == (2, 5, 3, V)
    np.testing.assert_allclose(s_t.detach().numpy(), np.asarray(s_j), atol=1e-5, rtol=0)
    np.testing.assert_allclose(v_t.detach().numpy(), np.asarray(v_j), atol=1e-5, rtol=0)


def test_unfused_matches_the_fused_layer(layer):
    """The unfused route and the packed layer (``message_layer_plain``) on the
    same layer inputs, float32, atol 1e-5."""
    _, mp_t, (s, v_cm, e, xi_cm, ft, em) = layer
    b, n = s.shape[:2]
    epack = np.concatenate([e, xi_cm.reshape(b, n, n, 3 * VE), ft.reshape(b, n, n, 9), em[..., None]],
                           axis=-1).reshape(b, n * n, -1)
    g1, chain = ml.detached(ml.pack_message_stack(mp_t, S, V, VE))
    s_f, v_f = ml.message_layer_plain(torch.from_numpy(s), torch.from_numpy(v_cm.reshape(b, n, 3 * V)),
                                      torch.from_numpy(epack), g1, chain, ve_dim=VE)
    with torch.no_grad():
        s_u, v_u = message_passing_unfused(mp_t, *(torch.from_numpy(a) for a in (s, v_cm, e, xi_cm, ft, em)))
    torch.testing.assert_close(s_u, s_f, atol=1e-5, rtol=0)
    torch.testing.assert_close(v_u.reshape(b, n, 3 * V), v_f, atol=1e-5, rtol=0)


def test_stack_chain_weights_are_the_packed_chain(layer):
    """``stack_chain_weights`` packed by ``chain_blocks`` is the message
    layer's chain tuple."""
    _, mp_t, _ = layer
    wd, wdf, ws, bs, wu, wg, bg, wattn, battn = stack_chain_weights(mp_t, torch.float32)
    w_comb, wu_bd = ml.chain_blocks(wd, wdf, wu)
    _, chain = ml.pack_message_stack(mp_t, S, V, VE)
    for a, b in zip((w_comb, ws, bs, wu_bd, wg, bg, wattn, battn), chain):
        assert torch.equal(a, b)


@pytest.mark.parametrize("what,error,match", [
    ("v", ValueError, r"v: shape"),
    ("ws", ValueError, r"ws: shape"),
    ("dtype", ValueError, r"bg: torch.float64"),
    ("float64", TypeError, r"float32 or bfloat16"),
    ("meta", RuntimeError, r"no GCP2-chain implementation"),
])
def test_chain_wrapper_validates_inputs(what, error, match):
    args = [torch.from_numpy(a) for a in chain_inputs(9, 16, 4, 2, 2, seed=1)]
    if what == "v":
        args[1] = args[1][:, :-1]
    elif what == "ws":
        args[5] = args[5][:, 1:]
    elif what == "dtype":
        args[9] = args[9].double()
    elif what == "float64":
        args = [a.double() for a in args]
    else:
        args = [a.to("meta") for a in args]
    with pytest.raises(error, match=match):
        fused_gcp2_chain(*args)
