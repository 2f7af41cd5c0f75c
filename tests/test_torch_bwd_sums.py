"""The message-layer backward's two reductions: the node sums
(``proj_sum_kernel``) and the weight grads with their split reduction folded
in (``weight_grad_kernel``), each alone on a scratch of the row kernel's
layout against its plain twin in ``ops/message_layer.py``.

This file imports no jax, so the card tests also run where only the port is
installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_bwd_sums.py

On the CPU: the Python copy of the scratch layout (``bwd_row_layout``), the
products list, and the twins against direct loops in float64.  On the card
(``cuda``-marked, skipped without one): each kernel against its twin at
tiny, QM9 (B=64, N=29) and GEOM-chunk (4 molecules at N=192) sizes, within
1e-4 of max|twin| (float32; the kernels add in index order from 0.f, PyTorch
in its own order), the in-place write of a later chunk exact, and the
weight-grad tile counters back at 0 after every launch.
"""

import numpy as np
import pytest
import torch

from bio_diffusion_torch.config.schema import LayerConfig, ModuleConfig
from bio_diffusion_torch.models.gcpnet import GCPMessagePassing
from bio_diffusion_torch.ops import message_layer as ml
from bio_diffusion_torch.train.torch_import import init_random_weights

# (s_dim, v_dim, se, ve, h1, hc, g) of the packed layers
TINY = (16, 4, 8, 2, 2, 1, 3)
QM9 = (256, 32, 64, 16, 20, 8, 3)
GEOM = (256, 32, 16, 8, 18, 8, 3)
TOL_SUMS = 1e-4


def scratch(widths, b, n, device="cpu", seed=0):
    width = ml.bwd_row_layout(*widths)["width"]
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn((b * n * n, width), generator=gen, device=device)


@pytest.mark.parametrize("dims,widths", [((16, 4, 8, 2), TINY), ((256, 32, 64, 16), QM9), ((256, 32, 16, 8), GEOM)])
def test_widths_and_grad_shapes_follow_the_packed_weights(dims, widths):
    """``bwd_widths`` reads the layout's widths off a layer's packed weights,
    and ``bwd_grad_shapes`` lists the 14 grads in the order the wrapper hands
    them to the kernel (GCP1's six, then the chain's eight)."""
    s_dim, v_dim, se, ve = dims
    mp = GCPMessagePassing((s_dim, v_dim), (se, ve), ModuleConfig(), LayerConfig())
    init_random_weights(mp, 0)
    g1, chain = ml.pack_message_stack(mp, s_dim, v_dim, ve)
    assert ml.bwd_widths(g1, chain, ve) == widths
    expected = [tuple(g1[k].shape) for k in ("wve", "wsx", "bs", "wu_bd", "wg", "bg")] + [tuple(c.shape) for c in chain]
    assert [tuple(s) for s in ml.bwd_grad_shapes(widths)] == expected


def test_scratch_layout_widths_and_chunk_plans():
    """The layout copy's row width: 6,040 floats at GEOM width (6,128 at
    QM9's), a multiple of 4 so every row starts 16-byte aligned; from it the
    wrapper's chunk plan keeps QM9's B=64 whole and walks GEOM's N=96 in 19
    molecules, N=192 in 4."""
    assert ml.bwd_row_layout(*GEOM)["width"] == 6040
    assert ml.bwd_row_layout(*QM9)["width"] == 6128
    for widths in (TINY, QM9, GEOM):
        assert ml.bwd_row_layout(*widths)["width"] % 4 == 0
    assert ml.bwd_chunk_molecules(29, 6128) >= 64
    assert ml.bwd_chunk_molecules(96, 6040) == 19
    assert ml.bwd_chunk_molecules(192, 6040) == 4


@pytest.mark.parametrize("widths", [TINY, QM9, GEOM])
def test_node_sum_columns_are_one_contiguous_range(widths):
    """GCP1's cotangent columns, d_vhd (W1) then d_s2 (S), lie side by side:
    the node sums read one range of W1 + S columns a row, and the slabs of
    the node-sum kernel tile it from an aligned column before it."""
    s_dim, h1 = widths[0], widths[4]
    rl = ml.bwd_row_layout(*widths)
    w1 = 3 * h1 + 27
    assert rl["ds2_1"] == rl["dvhd1"] + w1
    assert rl["dvu1"] == rl["ds2_1"] + s_dim
    assert rl["dvhd1"] + w1 + s_dim <= rl["width"]


def test_products_cover_every_grad_once():
    """Every grad element is written by exactly one product (the stage
    products once per stage), and every product reads columns inside a row."""
    widths = TINY
    shapes = ml.bwd_grad_shapes(widths)
    width = ml.bwd_row_layout(*widths)["width"]
    seen = {}
    for gi, bi, stage, xo, k, yo, nn in ml.bwd_weight_grad_products(widths):
        assert 0 <= xo and xo + k <= width and 0 <= yo and yo + nn <= width
        for idx in (gi, bi):
            if idx is not None:
                seen[(idx, stage)] = seen.get((idx, stage), 0) + 1
    g = widths[6]
    expected = {(i, None) for i in (0, 1, 2, 3, 4, 5, 12, 13)} | {(i, s) for i in range(6, 12) for s in range(g)}
    assert set(seen) == expected and set(seen.values()) == {1}
    assert len(shapes) == 14


def test_proj_sum_twin_matches_a_direct_loop():
    b, n = 2, 5
    rows = scratch(TINY, b, n, seed=1)
    rl = ml.bwd_row_layout(*TINY)
    s_dim, w1 = TINY[0], 3 * TINY[4] + 27
    r = rows.double().numpy().reshape(b, n, n, rl["width"])
    cols = list(range(rl["ds2_1"], rl["ds2_1"] + s_dim)) + list(range(rl["dvhd1"], rl["dvhd1"] + w1))
    want_i = np.zeros((b, n, s_dim + w1))
    want_j = np.zeros((b, n, s_dim + w1))
    for bb in range(b):
        for i in range(n):
            for j in range(n):
                want_i[bb, i] += r[bb, i, j, cols]
                want_j[bb, j] += r[bb, i, j, cols]
    got_i, got_j = ml.bwd_proj_sums_plain(rows, b, n, TINY)
    assert got_i.shape == got_j.shape == (b, n, s_dim + w1)
    np.testing.assert_allclose(got_i.double().numpy(), want_i, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got_j.double().numpy(), want_j, rtol=0, atol=1e-5)
    # on CPU tensors the dispatcher is the twin
    for a, c in zip(ml.bwd_proj_sums(rows, b, n, TINY), (got_i, got_j)):
        assert torch.equal(a, c)


def test_weight_grad_twin_matches_a_direct_loop():
    b, n = 2, 4
    rows = scratch(TINY, b, n, seed=2)
    r = rows.double().numpy()
    want = [np.zeros(s) for s in ml.bwd_grad_shapes(TINY)]
    for gi, bi, stage, xo, k, yo, nn in ml.bwd_weight_grad_products(TINY):
        prod = np.zeros((k, nn))
        bias = np.zeros(nn)
        for row in r:
            prod += np.outer(row[xo: xo + k], row[yo: yo + nn])
            bias += row[yo: yo + nn]
        dst = want[gi] if stage is None else want[gi][stage]
        dst[...] = prod.reshape(dst.shape)
        if bi is not None:
            (want[bi] if stage is None else want[bi][stage])[...] = bias
    got = ml.bwd_weight_grads_plain(rows, TINY)
    assert [tuple(t.shape) for t in got] == [tuple(s) for s in ml.bwd_grad_shapes(TINY)]
    for t, w in zip(got, want):
        assert t.dtype == torch.float32
        np.testing.assert_allclose(t.double().numpy(), w, rtol=1e-5, atol=1e-5)
    # given grads, the dispatcher (the twin on the CPU) adds onto them
    twice = ml.bwd_weight_grads(rows, b, n, TINY, out=[t.clone() for t in got])
    for t, g in zip(twice, got):
        assert torch.equal(t, g + g)


def test_reductions_refuse_a_scratch_of_another_layout():
    rows = scratch(TINY, 2, 3)
    with pytest.raises(ValueError, match="scratch"):
        ml.bwd_proj_sums(rows[:, :-4], 2, 3, TINY)
    with pytest.raises(ValueError, match="scratch"):
        ml.bwd_weight_grads(rows.double(), 2, 3, TINY)
    with pytest.raises(ValueError, match="scratch"):
        ml.bwd_proj_sums(rows, 3, 3, TINY)


def _counters_zero():
    torch.cuda.synchronize()
    return all(not bool(t.any()) for t in ml._bwd_tickets.values())


@pytest.mark.cuda
@pytest.mark.parametrize("widths,b,n", [(TINY, 3, 7), (QM9, 64, 29), (GEOM, 19, 23), (GEOM, 4, 192)])
def test_proj_sum_kernel_matches_twin_on_card(widths, b, n):
    """(GEOM, 19, 23) and (GEOM, 4, 192) give the kernel slabs of 16 and 8
    columns, QM9's B=64 slabs of 32."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    rows = scratch(widths, b, n, "cuda", seed=b + n)
    before = dict(ml.launch_counts)
    got = ml.bwd_proj_sums(rows, b, n, widths)
    want = ml.bwd_proj_sums_plain(rows, b, n, widths)
    torch.cuda.synchronize()
    assert ml.launch_counts == before
    for a, w in zip(got, want):
        assert a.shape == w.shape and torch.isfinite(a).all()
        assert (a - w).abs().max().item() <= TOL_SUMS * w.abs().max().item()
    # the same sums in the same order: bit-identical on a second launch
    assert all(torch.equal(a, c) for a, c in zip(got, ml.bwd_proj_sums(rows, b, n, widths)))


@pytest.mark.cuda
@pytest.mark.parametrize("widths,b,n", [(TINY, 3, 7), (QM9, 64, 29), (GEOM, 4, 192)])
def test_weight_grad_kernel_matches_twin_on_card(widths, b, n):
    """The folded reduction against torch.mm and sum(0); the accumulating
    write of a later chunk exactly twice the first; the tile counters 0
    after each launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = scratch(widths, b, n, "cuda", seed=b * n)
    got = ml.bwd_weight_grads(rows, b, n, widths)
    assert _counters_zero()
    want = ml.bwd_weight_grads_plain(rows, widths)
    torch.cuda.synchronize()
    for k, (a, w) in enumerate(zip(got, want)):
        assert a.shape == w.shape and torch.isfinite(a).all(), k
        assert (a - w).abs().max().item() <= TOL_SUMS * w.abs().max().item(), k
    again = ml.bwd_weight_grads(rows, b, n, widths)
    assert all(torch.equal(a, c) for a, c in zip(got, again))
    twice = ml.bwd_weight_grads(rows, b, n, widths, out=[t.clone() for t in got])
    assert all(torch.equal(t, g + g) for t, g in zip(twice, got))
    assert _counters_zero()


@pytest.mark.cuda
def test_backward_leaves_tile_counters_zero_on_card():
    """The whole backward, in one launch and in chunks of molecules (the
    in-kernel accumulation of a later chunk): counters 0 after each call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    s_dim, v_dim, se, ve = 16, 4, 8, 2
    mp = GCPMessagePassing((s_dim, v_dim), (se, ve), ModuleConfig(), LayerConfig())
    init_random_weights(mp, 4)
    g1, chain = ml.detached(ml.pack_message_stack(mp.to("cuda"), s_dim, v_dim, ve))
    gen = torch.Generator(device="cuda").manual_seed(4)
    b, n = 5, 9
    s = torch.randn(b, n, s_dim, generator=gen, device="cuda")
    v = torch.randn(b, n, 3 * v_dim, generator=gen, device="cuda")
    epack = torch.cat([torch.randn(b, n * n, se + 3 * ve + 9, generator=gen, device="cuda"),
                       torch.ones(b, n * n, 1, device="cuda")], -1)
    ct = (torch.randn(b, n, s_dim, generator=gen, device="cuda"), torch.randn(b, n, 3 * v_dim, generator=gen,
                                                                             device="cuda"))
    whole = ml.bwd_outputs(ml._message_layer_bwd_cuda(s, v, epack, g1, chain, ct, ve))
    assert _counters_zero()
    chunked = ml.bwd_outputs(ml._message_layer_bwd_cuda(s, v, epack, g1, chain, ct, ve, chunk_molecules=2))
    assert _counters_zero()
    for (name, a), (_, c) in zip(whole, chunked):
        assert a.shape == c.shape and torch.isfinite(c).all(), name
