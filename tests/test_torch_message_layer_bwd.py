"""Port parity: the backward of the packed message layer.

``message_layer_bwd_plain`` (autograd through the plain version) is held
against the JAX package's Pallas backward kernel in interpret mode
(``fused_message_layer_bwd(..., interpret=True)``) and against ``jax.vjp``
through ``message_layer_reference``, float32, on numpy-seeded inputs and
cotangents.  Tolerances are those of ``tests/test_fast_train.py`` for the
Pallas backward: node and edge cotangents rtol 5e-4 / atol 1e-5, weight grads
rtol 1e-3 / atol 1e-5.  The autograd ``Function`` is checked by
``torch.autograd.gradcheck`` in float64.  The CUDA kernel is held against the
plain version in ``test_torch_kernel.py`` (needs a card).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bio_diffusion_torch.config.schema import LayerConfig, ModuleConfig
from bio_diffusion_tpu.models.gcpnet_fast import message_layer_reference
from bio_diffusion_tpu.ops.pallas.gcp_kernel import fused_message_layer_bwd as jax_bwd
from bio_diffusion_torch.models.gcpnet import GCPMessagePassing
from bio_diffusion_torch.ops import message_layer as ml
from bio_diffusion_torch.train.torch_import import init_random_weights
from test_torch_message_layer import VE, as_torch, layer_inputs, packed  # noqa: F401

TOL_NODE = dict(rtol=5e-4, atol=1e-5)
TOL_WEIGHT = dict(rtol=1e-3, atol=1e-5)


def cotangents(b, n, s_dim, v3, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, n, s_dim)).astype(np.float32),
            rng.normal(size=(b, n, v3)).astype(np.float32))


def port_bwd(s, v, epack, g1, chain, ct):
    return ml.message_layer_bwd_plain(torch.from_numpy(s), torch.from_numpy(v), torch.from_numpy(epack),
                                      g1, chain, tuple(torch.from_numpy(c) for c in ct), ve_dim=VE)


def assert_bwd_close(port, ref, p):
    d_sn, d_vn, d_ep, d_g1, d_chain = port
    r_sn, r_vn, r_ep, r_g1, r_chain = ref
    np.testing.assert_allclose(d_sn.numpy(), np.asarray(r_sn), **TOL_NODE, err_msg="d_s_node")
    np.testing.assert_allclose(d_vn.numpy(), np.asarray(r_vn), **TOL_NODE, err_msg="d_v_node")
    # the JAX layout pads epack to 128 columns: compare the unpadded ones
    np.testing.assert_allclose(d_ep.numpy(), np.asarray(r_ep)[..., :p], **TOL_NODE, err_msg="d_epack")
    assert set(d_g1) == set(ml.G1_KEYS)
    for k in ml.G1_KEYS:
        np.testing.assert_allclose(d_g1[k].numpy(), np.asarray(r_g1[k]), **TOL_WEIGHT, err_msg=f"d_g1[{k}]")
    assert len(d_chain) == len(r_chain) == len(ml.CHAIN_KEYS)
    for name, a, b in zip(ml.CHAIN_KEYS, d_chain, r_chain):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL_WEIGHT, err_msg=f"d_chain[{name}]")


def test_bwd_plain_matches_pallas_interpret(packed):  # noqa: F811
    g1_j, chain_j, g1_t, chain_t = packed
    s, v, epack = layer_inputs(2, 5, [(1, 2)], seed=11)
    ct = cotangents(2, 5, s.shape[-1], v.shape[-1], seed=12)
    p = epack.shape[-1]
    ep_j = np.pad(epack, ((0, 0), (0, 0), (0, 128 - p)))
    ref = jax_bwd(jnp.asarray(s), jnp.asarray(v), jnp.asarray(ep_j),
                  {k: jnp.asarray(x) for k, x in g1_j.items()}, chain_j,
                  tuple(jnp.asarray(c) for c in ct), ve_dim=VE, interpret=True)
    assert_bwd_close(port_bwd(s, v, epack, g1_t, chain_t, ct), ref, p)


def test_bwd_plain_matches_jax_vjp_of_reference(packed):  # noqa: F811
    g1_j, chain_j, _, _ = packed
    s, v, epack = layer_inputs(3, 6, [(2, 1), (0, 3)], seed=13)
    ct = cotangents(3, 6, s.shape[-1], v.shape[-1], seed=14)
    g1_jj = {k: jnp.asarray(x) for k, x in g1_j.items()}

    def ref_fn(s_, v_, e_, g_, c_):
        return message_layer_reference(s_, v_, e_, g_, c_, ve_dim=VE)

    _, vjp = jax.vjp(ref_fn, jnp.asarray(s), jnp.asarray(v), jnp.asarray(epack), g1_jj, chain_j)
    ref = vjp(tuple(jnp.asarray(c) for c in ct))
    # the port's backward on JAX's own packing of the same weights
    g1_t, chain_t = as_torch(g1_j, chain_j)
    assert_bwd_close(port_bwd(s, v, epack, g1_t, chain_t, ct), ref, epack.shape[-1])


def small_layer(dtype, b=2, n=3, seed=0):
    """A randomly initialized S=8, V=4, Se=4, Ve=2 message stack (H1=2,
    Hc=1), packed, with seeded inputs; the last molecule has a padded row."""
    s_dim, v_dim, se, ve = 8, 4, 4, 2
    mp = GCPMessagePassing((s_dim, v_dim), (se, ve), ModuleConfig(), LayerConfig())
    init_random_weights(mp, seed)
    g1, chain = ml.detached(ml.pack_message_stack(mp, s_dim, v_dim, ve, dtype))
    gen = torch.Generator().manual_seed(seed + 1)
    mask = torch.ones(b, n, dtype=dtype)
    mask[-1, -1] = 0
    em = (mask[:, :, None] * mask[:, None, :]).reshape(b, n * n, 1)
    epack = torch.cat([torch.randn(b, n * n, se, generator=gen, dtype=dtype),
                       torch.randn(b, n * n, 3 * ve, generator=gen, dtype=dtype),
                       torch.rand(b, n * n, 9, generator=gen, dtype=dtype) * 2 - 1, em], dim=-1) * em
    s = torch.randn(b, n, s_dim, generator=gen, dtype=dtype) * mask[..., None]
    v = torch.randn(b, n, 3 * v_dim, generator=gen, dtype=dtype) * mask[..., None]
    return s, v, epack, g1, chain, ve


def test_message_layer_function_gradcheck():
    """The autograd Function (forward and backward through the wrapper,
    plain versions on CPU tensors) against finite differences, float64."""
    s, v, epack, g1, chain, ve = small_layer(torch.float64)
    inputs = [x.clone().requires_grad_(True) for x in [s, v, epack, *[g1[k] for k in ml.G1_KEYS], *chain]]

    def fn(s_, v_, e_, *w):
        return ml.message_layer(s_, v_, e_, dict(zip(ml.G1_KEYS, w[:10])), tuple(w[10:]), ve_dim=ve)

    before = dict(ml.launch_counts)
    assert torch.autograd.gradcheck(fn, inputs, eps=1e-6, atol=1e-6, rtol=1e-4)
    assert ml.launch_counts == before  # no kernel on CPU tensors


def test_bwd_dispatch_on_cpu_and_other_devices():
    s, v, epack, g1, chain, ve = small_layer(torch.float32)
    ct = (torch.ones_like(s), torch.ones_like(v))
    before = ml.launch_counts["message_layer_bwd"]
    out = ml.fused_message_layer_bwd(s, v, epack, g1, chain, ct, ve_dim=ve)
    ref = ml.message_layer_bwd_plain(s, v, epack, g1, chain, ct, ve_dim=ve)
    flat = lambda o: [o[0], o[1], o[2], *[o[3][k] for k in ml.G1_KEYS], *o[4]]  # noqa: E731
    assert all(torch.equal(a, b) for a, b in zip(flat(out), flat(ref)))
    assert ml.launch_counts["message_layer_bwd"] == before
    with pytest.raises(RuntimeError, match="no message-layer implementation"):
        ml.fused_message_layer_bwd(*(a.to("meta") for a in (s, v, epack)), g1, chain, ct, ve_dim=ve)


@pytest.mark.parametrize("what,expected", [
    ("d_s_agg", "d_s_agg: shape"),
    ("d_v_agg", "d_v_agg: torch.bfloat16"),
    ("epack", "epack: shape"),
])
def test_bwd_wrapper_validates_inputs(what, expected):
    """The CUDA backward wrapper refuses what the kernel does not take,
    before any build or launch (checked here on CPU tensors)."""
    s, v, epack, g1, chain, ve = small_layer(torch.float32)
    ds, dv = torch.zeros_like(s), torch.zeros_like(v)
    if what == "d_s_agg":
        ds = ds[:, :-1]
    elif what == "d_v_agg":
        dv = dv.to(torch.bfloat16)
    else:
        epack = epack[..., :-1]
    with pytest.raises(ValueError, match=expected):
        ml._message_layer_bwd_cuda(s, v, epack, g1, chain, (ds, dv), ve)
