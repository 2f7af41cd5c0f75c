"""The CUDA kernels (the message layer's forward and backward, the flat-edge
GCP2 chain, the pass probe) against their plain PyTorch versions.

This file imports no jax, so the card tests also run where only the port is
installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernel.py

The ``cuda``-marked tests skip without a CUDA device (the kernels have no
CPU mode).  Forward tolerance relative to max|plain|: float32 1e-4 (TF32 off;
only the summation order differs), bfloat16 2e-2 (the kernel rounds to bf16
where the TPU kernel does, the plain version after every op); the backward's
are at ``TOL_BWD``, and two backward runs must be bit-identical.  The chain
kernel is held at the forward's tolerances, the pass probe at rtol 1e-5 of
max|plain| (float32; only the sigmoid and silu forms and the rsqrt
approximation differ), at k = 0 to 104 passes over a ragged array and a
view 4 bytes past a 16-byte boundary.

In bfloat16 the forward and the chain kernel run their wide products on the
tensor cores (mma.sync over m16 row tiles, ragged K and columns masked).  The
forward's shapes cover its routes: (TINY, 3, 7) one m16 tile, every K and
some columns ragged (K not a multiple of 16, V=4 gate columns); (TINY, 2,
40) a second target tile of 8 rows; (QM9, 8, 19) and the training shape
(QM9, 64, 29) two m16 tiles with the second partly real; (QM9, 2, 64) two
full 32-row tiles.  The chain's E=70 and 4,001 end in ragged tiles of 6 and
1 rows.  The backward's shapes add the training shape (QM9, 64, 29), whose
53,824 edge rows end in a partial row chunk of the weight grads, and (QM9,
3, 23), target tiles of 16 and 7 rows and 1,587 rows, one partial chunk; at
QM9 width every weight-grad product has a ragged output tile (K = 48, 93,
60, 17, 96, 24; N = 87, 51) or column-sum tile (the one-column attention
weight, N=1), and the tiny widths make every tile ragged.  GEOM's width (Se=16,
Ve=8: H1=18, wsx's K=43, 81 GCP1 columns) runs the forward at N=53 (a ragged
second tile) and N=181 (six tiles, the last of 21 rows) and the backward at
N=53; the backward's chunks of molecules are held against its whole batch,
and the wrapper's chunk plan against the kernel's row width.

The forward computes only the edge rows its mask keeps: with NaN in every
padded row its real nodes' outputs are those of the zero-padded run bit for
bit and its padded nodes' exactly 0 (QM9 width, sizes 0 to 29 at N=29; GEOM
width, sizes 20 to 96 at N=96, whole 32-row tiles skipped); a mask with
holes (no prefix of the targets kept, weights of 0.5) is held against the
plain version at the forward's tolerances; and its shared memory, with the
list of kept targets, still fits two blocks on an SM.
"""

import pytest
import torch

from bio_diffusion_torch.config.schema import LayerConfig, ModuleConfig
from bio_diffusion_torch.models.gcpnet import GCPMessagePassing, stack_chain_weights
from bio_diffusion_torch.ops import message_layer as ml
from bio_diffusion_torch.ops.gcp2_chain import fused_gcp2_chain, gcp2_chain_plain
from bio_diffusion_torch.ops.passes import OPS, repeat_op, repeat_op_plain
from bio_diffusion_torch.train.torch_import import init_random_weights

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
TINY = (16, 4, 8, 2)  # S, V, Se, Ve
QM9 = (256, 32, 64, 16)
GEOM = (256, 32, 16, 8)  # H1 = 18: 3 H1 + 27 = 81 columns, wsx's K = 43


def make_layer(dims, dtype, device, b, n, seed=0):
    """Packed weights of a randomly initialized message stack and seeded
    inputs with padded rows in the last molecule."""
    s_dim, v_dim, se, ve = dims
    mp = GCPMessagePassing((s_dim, v_dim), (se, ve), ModuleConfig(), LayerConfig())
    init_random_weights(mp, seed)
    g1, chain = ml.detached(ml.pack_message_stack(mp.to(device), s_dim, v_dim, ve, dtype))
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
@pytest.mark.parametrize("dims,b,n", [(TINY, 3, 7), (TINY, 2, 40), (QM9, 8, 19), (QM9, 64, 29),
                                      (QM9, 2, 64), (GEOM, 2, 53), (GEOM, 1, 181)])
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


def masked_layer(dims, dtype, sizes, n, fill, seed=0):
    """``make_layer``'s weights and seeded inputs for molecules of ``sizes``
    atoms padded at the end to ``n``, on the card: the real nodes' and real
    edge rows' values drawn, every padded edge row's non-mask columns and
    the padded nodes' ``s`` and ``v`` set to ``fill``, the mask column the
    outer product of the node mask."""
    b = len(sizes)
    (s, v, epack), g1, chain, ve = make_layer(dims, dtype, "cuda", b, n, seed)
    gen = torch.Generator().manual_seed(seed + 2)
    s, v = torch.randn(s.shape, generator=gen), torch.randn(v.shape, generator=gen)
    epack = torch.randn(epack.shape, generator=gen)
    mask = (torch.arange(n)[None, :] < torch.tensor(sizes)[:, None]).float()
    em = (mask[:, :, None] * mask[:, None, :]).reshape(b, n * n, 1)
    epack = torch.cat([torch.where(em > 0, epack[..., :-1], torch.full_like(epack[..., :-1], fill)), em], dim=-1)
    s, v = (torch.where(mask[..., None] > 0, t, torch.full_like(t, fill)) for t in (s, v))
    return [t.to("cuda", dtype) for t in (s, v, epack)], mask.bool().cuda(), g1, chain, ve


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dims,n,sizes", [(QM9, 29, [0, 1, 7, 13, 19, 24, 28, 29]),
                                          (GEOM, 96, [20, 33, 64, 96])])
def test_kernel_skips_padded_rows_bit_for_bit_on_card(dtype, dims, n, sizes):
    """The forward computes only the edge rows its mask keeps: with NaN in
    every padded edge row and padded node, the real nodes' outputs equal the
    run with those values zeroed bit for bit, no NaN appears, and the padded
    nodes' outputs are exactly 0.  QM9's sizes span one tile of targets from
    a molecule of no atom to none padded; GEOM's skip whole 32-row tiles."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    (s, v, epack), mask, g1, chain, ve = masked_layer(dims, dtype, sizes, n, float("nan"))
    (s0, v0, epack0), _, _, _, _ = masked_layer(dims, dtype, sizes, n, 0.0)
    nan_out = ml.fused_message_layer(s, v, epack, g1, chain, ve_dim=ve)
    zero_out = ml.fused_message_layer(s0, v0, epack0, g1, chain, ve_dim=ve)
    plain = ml.message_layer_plain(s0, v0, epack0, g1, chain, ve_dim=ve)
    torch.cuda.synchronize()
    for got, zeroed, p in zip(nan_out, zero_out, plain):
        assert not torch.isnan(got).any()
        assert torch.equal(got[mask], zeroed[mask])
        assert torch.equal(got[~mask], torch.zeros_like(got[~mask]))
        assert torch.equal(zeroed[~mask], torch.zeros_like(zeroed[~mask]))
        err = (zeroed.float() - p.float()).abs().max().item()
        assert err <= TOL[dtype] * p.float().abs().max().item(), err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dims,b,n", [(QM9, 3, 29), (GEOM, 2, 53)])
def test_kernel_matches_plain_with_holes_in_the_mask_on_card(dtype, dims, b, n):
    """A mask with holes: a real atom masked out mid-molecule, and edges
    dropped (or weighted 0.5) so that the edge mask is no outer product; the
    kept rows are then no prefix of 0..N-1.  The masked rows keep their
    values, which the plain version multiplies by 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    (s, v, epack), g1, chain, ve = make_layer(dims, dtype, "cuda", b, n, seed=5)
    gen = torch.Generator().manual_seed(7)
    s, v = (torch.randn(t.shape, generator=gen).to("cuda", dtype) for t in (s, v))
    node = torch.ones(b, n)
    node[0, n // 2] = 0  # a hole mid-molecule
    node[-1, n - 4:] = 0  # trailing padding
    em = node[:, :, None] * node[:, None, :]
    drop = torch.rand(b, n, n, generator=gen)
    em = torch.where(drop < 0.3, torch.zeros_like(em), torch.where(drop > 0.9, 0.5 * em, em))
    epack = torch.cat([torch.randn(b, n * n, epack.shape[-1] - 1, generator=gen), em.reshape(b, n * n, 1)], dim=-1)
    epack = epack.to("cuda", dtype)
    sk, vk = ml.fused_message_layer(s, v, epack, g1, chain, ve_dim=ve)
    sp, vp = ml.message_layer_plain(s, v, epack, g1, chain, ve_dim=ve)
    torch.cuda.synchronize()
    for k, p in ((sk, sp), (vk, vp)):
        assert k.dtype == dtype and torch.isfinite(k).all()
        err = (k.float() - p.float()).abs().max().item()
        assert err <= TOL[dtype] * p.float().abs().max().item(), err


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [0, 1])
@pytest.mark.parametrize("dims,h1,n", [(QM9, 20, 29), (GEOM, 18, 192)])
def test_kernel_holds_two_blocks_per_sm_on_card(bf16, dims, h1, n):
    """The forward's shared memory (its tile and the list of kept targets, N
    ints) leaves room for two blocks on an SM at QM9's and GEOM's widths and
    largest padded sizes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the occupancy query")
    import ctypes

    from bio_diffusion_torch.ops.build import load_library

    lib = load_library("message_layer")
    lib.message_layer_smem_bytes.argtypes = [ctypes.c_int] * 7
    lib.message_layer_blocks_per_sm.argtypes = [ctypes.c_int] * 2
    lib.message_layer_smem_bytes.restype = lib.message_layer_blocks_per_sm.restype = ctypes.c_int
    s_dim, v_dim, se, ve = dims
    smem = lib.message_layer_smem_bytes(s_dim, v_dim, se, ve, h1, 8, n)
    assert smem == lib.message_layer_smem_bytes(s_dim, v_dim, se, ve, h1, 8, 0) + 4 * n
    assert lib.message_layer_blocks_per_sm(bf16, smem) == 2


# backward kernel vs plain version, relative to max|plain| of each output:
# float32 differs only in summation order; in bfloat16 the plain version
# rounds every intermediate cotangent to bf16, the kernel accumulates in f32
TOL_BWD = {torch.float32: 1e-4, torch.bfloat16: 5e-2}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dims,b,n", [(TINY, 3, 7), (TINY, 2, 29), (QM9, 4, 19), (QM9, 4, 29),
                                      (QM9, 2, 64), (QM9, 64, 29), (QM9, 3, 23), (GEOM, 2, 53)])
def test_bwd_kernel_matches_plain_on_card(dtype, dims, b, n):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    (s, v, epack), g1, chain, ve = make_layer(dims, dtype, "cuda", b, n)
    gen = torch.Generator(device="cuda").manual_seed(b * 100 + n)
    ct = (torch.randn(s.shape, generator=gen, device="cuda").to(dtype),
          torch.randn(v.shape, generator=gen, device="cuda").to(dtype))
    before = ml.launch_counts["message_layer_bwd"]
    out = ml.bwd_outputs(ml.fused_message_layer_bwd(s, v, epack, g1, chain, ct, ve_dim=ve))
    assert ml.launch_counts["message_layer_bwd"] == before + 1
    again = ml.bwd_outputs(ml.fused_message_layer_bwd(s, v, epack, g1, chain, ct, ve_dim=ve))
    plain = ml.bwd_outputs(ml.message_layer_bwd_plain(s, v, epack, g1, chain, ct, ve_dim=ve))
    torch.cuda.synchronize()
    for (name, k), (_, k2), (_, p) in zip(out, again, plain):
        assert k.dtype == p.dtype and k.shape == p.shape, name
        assert torch.equal(k, k2), f"{name}: two runs differ"
        assert torch.isfinite(k).all(), name
        err = (k.float() - p.float()).abs().max().item()
        ref = p.float().abs().max().item()
        print(f"{dtype} dims={dims} B={b} N={n} {name}: err {err:.3g} max|plain| {ref:.3g}")
        assert err <= TOL_BWD[dtype] * ref, (name, err, ref)


# the backward's per-molecule outputs: bit-identical however the batch is cut
PER_MOLECULE = ("d_s_node", "d_v_node", "d_epack", "d_g1[wsi]", "d_g1[wsj]", "d_g1[wvi]", "d_g1[wvj]")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_kernel_chunks_equal_whole_batch_on_card(dtype):
    """The backward kernel at GEOM width, B=5, N=21, walked in chunks of 2
    molecules and of 1 (a call-level chunk size of the wrapper's helper)
    against one call over the batch: the per-molecule outputs bit-identical,
    the weight grads (summed over the chunks in order in f32) within 1e-5
    of max|·| in float32, and in bfloat16 within one bf16 rounding of the
    f32 sum (2^-8 of max|·|), two chunked runs bit-identical."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    (s, v, epack), g1, chain, ve = make_layer(GEOM, dtype, "cuda", 5, 21, seed=3)
    gen = torch.Generator(device="cuda").manual_seed(5)
    ct = (torch.randn(s.shape, generator=gen, device="cuda").to(dtype),
          torch.randn(v.shape, generator=gen, device="cuda").to(dtype))
    assert ml.bwd_chunks(s, v, epack, g1, chain, ve_dim=ve)[:2] == (5, 1)
    whole = ml.bwd_outputs(ml._message_layer_bwd_cuda(s, v, epack, g1, chain, ct, ve))
    for chunk in (2, 1):
        before = ml.launch_counts["message_layer_bwd"]
        runs = [ml.bwd_outputs(ml._message_layer_bwd_cuda(s, v, epack, g1, chain, ct, ve, chunk_molecules=chunk))
                for _ in range(2)]
        # one launch a chunk: 3 chunks of up to 2 molecules, 5 of 1
        assert ml.launch_counts["message_layer_bwd"] == before + 2 * -(-5 // chunk)
        for (name, got), (_, again), (_, ref) in zip(*runs, whole):
            assert torch.equal(got, again), f"{name}: two chunked runs differ"
            if name in PER_MOLECULE:
                assert torch.equal(got, ref), f"{name}: chunks of {chunk} differ from the whole batch"
            else:
                tol = 1e-5 if dtype == torch.float32 else 2.0 ** -8
                assert (got.float() - ref.float()).abs().max() <= tol * ref.float().abs().max(), name


@pytest.mark.cuda
def test_bwd_chunk_plan_on_card():
    """The wrapper's plan from the kernel's own row width: QM9's training
    shape in one chunk, GEOM's largest bucket in 16 chunks of 4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel's workspace query")
    for dims, b, n, plan in ((QM9, 64, 29, (64, 1)), (GEOM, 64, 192, (4, 16)), (GEOM, 64, 96, (19, 4))):
        (s, v, epack), g1, chain, ve = make_layer(dims, torch.float32, "cuda", 1, n)
        s, v, epack = (t.expand(b, *t.shape[1:]).contiguous() for t in (s, v, epack))
        assert ml.bwd_chunks(s, v, epack, g1, chain, ve_dim=ve)[:2] == plan, (dims, b, n)


@pytest.mark.cuda
@pytest.mark.parametrize("n,plan", [(48, (32, 1)), (64, (32, 1)), (96, (19, 2)), (128, (10, 4)), (144, (8, 4))])
def test_pocket_bwd_chunk_plan_on_card(n, plan):
    """The pocket model (GEOM widths) trains at B=32 in the buckets [48,
    64, 96, 128, 144]: the wrapper walks a micro-batch in 1 / 1 / 2 / 4 / 4
    chunks."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel's workspace query")
    (s, v, epack), g1, chain, ve = make_layer(GEOM, torch.float32, "cuda", 1, n)
    s, v, epack = (t.expand(32, *t.shape[1:]).contiguous() for t in (s, v, epack))
    assert ml.bwd_chunks(s, v, epack, g1, chain, ve_dim=ve)[:2] == plan


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dims,e", [(TINY, 70), (QM9, 1000), (QM9, 4001)])
def test_chain_kernel_matches_plain_on_card(dtype, dims, e):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    s_dim, v_dim, se, ve = dims
    mp = GCPMessagePassing((s_dim, v_dim), (se, ve), ModuleConfig(), LayerConfig())
    init_random_weights(mp, e)
    gen = torch.Generator().manual_seed(e)
    rows = [torch.randn(e, s_dim, generator=gen), torch.randn(e, 3 * v_dim, generator=gen),
            torch.rand(e, 9, generator=gen) * 2 - 1]
    args = [t.to("cuda", dtype) for t in rows] + [w.detach() for w in stack_chain_weights(mp.to("cuda"), dtype)]
    before = ml.launch_counts["gcp2_chain"]
    out = fused_gcp2_chain(*args)
    assert ml.launch_counts["gcp2_chain"] == before + 1
    plain = gcp2_chain_plain(*args)
    torch.cuda.synchronize()
    for k, p in zip(out, plain):
        assert k.dtype == dtype and k.shape == p.shape and torch.isfinite(k).all()
        err = (k.float() - p.float()).abs().max().item()
        assert err <= TOL[dtype] * p.float().abs().max().item(), err


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["ragged", "misaligned"])
@pytest.mark.parametrize("k", [0, 1, 3, 8, 104])
@pytest.mark.parametrize("op", OPS)
def test_passes_kernel_matches_plain_on_card(op, k, layout):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(k)
    if layout == "ragged":  # 77,077 elements: a partial last tile and a scalar tail
        x = torch.randn(1001, 77, generator=gen, device="cuda")
    else:  # 4 bytes past a 16-byte boundary: a scalar head of 3
        x = torch.randn(1001 * 77 + 1, generator=gen, device="cuda").flatten()[1:]
    before = ml.launch_counts["elementwise_passes"]
    out = repeat_op(x, op, k)
    assert ml.launch_counts["elementwise_passes"] == before + 1
    plain = repeat_op_plain(x, op, k)
    torch.cuda.synchronize()
    assert out.shape == x.shape
    finite = torch.isfinite(plain)
    assert torch.equal(torch.isfinite(out), finite)
    err = (out - plain)[finite].abs().max().item() if finite.any() else 0.0
    assert err <= 1e-5 * max(1.0, plain[finite].abs().max().item() if finite.any() else 0.0), err
