"""The message-layer CUDA kernel against its plain PyTorch version.

This file imports no jax, so the card tests also run where only the port is
installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernel.py

The ``cuda``-marked tests skip without a CUDA device (the kernel has no CPU
mode).  Tolerance relative to max|plain|: float32 1e-4 (TF32 off; only the
summation order differs), bfloat16 2e-2 (the kernel rounds to bf16 where the
TPU kernel does, the plain version after every op).
"""

import pytest
import torch

from bio_diffusion_tpu.config.schema import LayerConfig, ModuleConfig
from bio_diffusion_torch.cli.serve import init_random_weights
from bio_diffusion_torch.models.gcpnet import GCPMessagePassing
from bio_diffusion_torch.ops import message_layer as ml

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
TINY = (16, 4, 8, 2)  # S, V, Se, Ve
QM9 = (256, 32, 64, 16)


def make_layer(dims, dtype, device, b, n, seed=0):
    """Packed weights of a randomly initialized message stack and seeded
    inputs with padded rows in the last molecule."""
    s_dim, v_dim, se, ve = dims
    mp = GCPMessagePassing((s_dim, v_dim), (se, ve), ModuleConfig(), LayerConfig())
    init_random_weights(mp, seed)
    g1 = {k: x.to(device) for k, x in ml.pack_gcp1_weights(mp.message_fusion[0], s_dim, v_dim, ve, dtype).items()}
    chain = tuple(x.to(device) for x in ml.pack_chain_weights(mp.message_fusion[1:],
                                                               mp.scalar_message_attention[0], dtype))
    gen = torch.Generator().manual_seed(seed + 1)
    mask = torch.ones(b, n)
    mask[-1, n - min(3, n - 1):] = 0
    em = (mask[:, :, None] * mask[:, None, :]).reshape(b, n * n, 1)
    epack = torch.cat([torch.randn(b, n * n, se, generator=gen),
                       torch.randn(b, n * n, 3 * ve, generator=gen),
                       torch.rand(b, n * n, 9, generator=gen) * 2 - 1, em], dim=-1) * em
    s = torch.randn(b, n, s_dim, generator=gen) * mask[..., None]
    v = torch.randn(b, n, 3 * v_dim, generator=gen) * mask[..., None]
    return [t.to(device, dtype) for t in (s, v, epack)], g1, chain, ve


@pytest.mark.parametrize("what,expected", [
    ("epack", "epack: shape"),
    ("dtype", "wsx: torch.float32"),
])
def test_kernel_wrapper_validates_inputs(what, expected):
    """The CUDA wrapper refuses what the kernel does not take, before any
    build or launch (checked here on CPU tensors)."""
    (s, v, epack), g1, chain, ve = make_layer(TINY, torch.bfloat16, "cpu", 2, 5)
    if what == "epack":
        epack = epack[..., :-1]
    else:
        g1 = dict(g1, wsx=g1["wsx"].float())
    with pytest.raises(ValueError, match=expected):
        ml._message_layer_cuda(s, v, epack, g1, chain, ve)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dims,b,n", [(TINY, 3, 7), (TINY, 2, 40), (QM9, 8, 19), (QM9, 2, 64)])
def test_kernel_matches_plain_on_card(dtype, dims, b, n):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    (s, v, epack), g1, chain, ve = make_layer(dims, dtype, "cuda", b, n)
    before = ml.launch_counts["message_layer"]
    sk, vk = ml.fused_message_layer(s, v, epack, g1, chain, ve_dim=ve)
    assert ml.launch_counts["message_layer"] == before + 1
    sp, vp = ml.message_layer_plain(s, v, epack, g1, chain, ve_dim=ve)
    torch.cuda.synchronize()
    for k, p in ((sk, sp), (vk, vp)):
        assert k.dtype == dtype and torch.isfinite(k).all()
        err = (k.float() - p.float()).abs().max().item()
        assert err <= TOL[dtype] * p.float().abs().max().item(), err
