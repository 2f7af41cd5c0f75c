"""The per-pass cost probe: plain version against JAX, the wrapper, the slope
fit, the forward kernel's pass accounting, the kernel's head/body/tail split,
each op's bound from its SASS counts and the reading of those counts.

The probe's ops are lambdas local to ``scripts/bench_vpu_passes.py::main``
(``:54-65``), so they are written out here as ``JAX_OPS``.  Each op applied k
times by ``repeat_op_plain`` is held against the same op applied k times with
jnp, float32, rtol 1e-5 (the port's sigmoid and silu are exp-form PyTorch
calls, the script's the tanh form: an exact identity), 1e-3 for exp, whose
passes amplify the relative error.  The CUDA kernel is held
against the plain version in ``test_torch_kernel.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bio_diffusion_torch.cli import bench_passes
from bio_diffusion_torch.ops import message_layer as ml
from bio_diffusion_torch.ops.passes import OPS, _empty_aligned_as, repeat_op, repeat_op_plain, split_for_vectors

# scripts/bench_vpu_passes.py:54-65
JAX_OPS = {
    "tanh": lambda y: jnp.tanh(y),
    "exp": lambda y: jnp.exp(y),
    "sigmoid_exp": lambda y: 1.0 / (1.0 + jnp.exp(-y)),
    "sigmoid_tanh": lambda y: 0.5 * (jnp.tanh(0.5 * y) + 1.0),
    "silu_tanh": lambda y: y * (0.5 * (jnp.tanh(0.5 * y) + 1.0)),
    "add": lambda y: y + 1.0,
    "mul": lambda y: y * 1.0001,
    "rsqrt": lambda y: jax.lax.rsqrt(jnp.abs(y) + 1e-8),
    "cast_roundtrip": lambda y: y.astype(jnp.bfloat16).astype(jnp.float32),
}


def test_the_nine_ops():
    assert OPS == tuple(JAX_OPS)


@pytest.mark.parametrize("op", OPS)
def test_repeat_op_plain_matches_jax(op):
    x = np.random.default_rng(OPS.index(op)).normal(size=(7, 33)).astype(np.float32)
    k = 4
    y = jnp.asarray(x)
    for _ in range(k):
        y = JAX_OPS[op](y)
    ours = repeat_op_plain(torch.from_numpy(x), op, k).numpy()
    assert ours.dtype == np.float32
    # a pass of exp multiplies the relative error it receives by its input
    # (up to ~60 here), so after k passes its tolerance is wider
    rtol = 1e-3 if op == "exp" else 1e-5
    np.testing.assert_allclose(ours, np.asarray(y), rtol=rtol, atol=1e-6)


def test_repeat_op_takes_plain_version_on_cpu():
    x = torch.from_numpy(np.random.default_rng(9).normal(size=(5, 6)).astype(np.float32))
    before = ml.launch_counts["elementwise_passes"]
    assert torch.equal(repeat_op(x, "silu_tanh", 3), repeat_op_plain(x, "silu_tanh", 3))
    assert torch.equal(repeat_op(x, "add", 0), x)
    assert ml.launch_counts["elementwise_passes"] == before  # no kernel launched on the CPU


@pytest.mark.parametrize("args,error,match", [
    ((torch.zeros(3), "gelu", 2), ValueError, "unknown op"),
    ((torch.zeros(3, dtype=torch.float64), "add", 2), TypeError, "float32"),
    ((torch.zeros(3), "add", -1), ValueError, "non-negative"),
    ((torch.zeros(3, device="meta"), "add", 2), RuntimeError, "no pass-probe implementation"),
])
def test_repeat_op_validates_inputs(args, error, match):
    with pytest.raises(error, match=match):
        repeat_op(*args)


def test_slope_fit():
    # a launch of k passes takes c + k * p
    c, p = 0.055, 0.0007
    t = {k: c + k * p for k in (bench_passes.K_LO, bench_passes.K_HI)}
    assert bench_passes.slope(t[bench_passes.K_LO], t[bench_passes.K_HI]) == pytest.approx(p, rel=1e-12)


def test_forward_pass_accounting():
    items = bench_passes.forward_passes(**bench_passes.QM9, n=19, bf16=True)
    counts = {what: count for what, _, count in items}
    # 298,032 multiply-adds per edge row at QM9 width (message_layer.cu
    # header); in bf16 266,240 of them (wsx 93x256, wg 256x32, three wsc
    # 273x256 and wg) run on the tensor cores, over 32 computed rows per 19
    assert counts["products (FMA)"] == pytest.approx((298032 - 266240) / 256)
    assert counts["products (tensor cores, at the bf16 peak)"] == pytest.approx(266240 / 256 * 32 / 19)
    # m16 tiles of 32-row tiles: one for <= 16 rows, two for 17-32, and so on
    assert [bench_passes.mma_rows(n) for n in (7, 16, 19, 29, 40, 64)] == [16, 16, 32, 32, 48, 64]
    f32 = {what: count for what, _, count in bench_passes.forward_passes(**bench_passes.QM9, n=19, bf16=False)}
    assert f32["products (FMA)"] == pytest.approx(298032 / 256)
    # rounded values per row: 4 stages of silu, gate, vh, norms, vu, vu * gate;
    # the chain's residual sums; the attention scale and the summed terms
    assert counts["bf16 rounding"] == pytest.approx(3541 / 256)
    assert "bf16 rounding" not in f32 and "products (tensor cores, at the bf16 peak)" not in f32
    # one pass over the probe's array costs 1 ms per op: the layer's items
    # scale by its elements over the probe's
    rows = 250 * 19 * 19
    acct = bench_passes.account(items, {op: 1.0 for op in OPS + ("mma",)}, probe_elems=rows * 128,
                                layer_rows=rows, s_dim=256)
    assert set(acct) == set(counts)
    for what, ms in acct.items():
        assert ms == pytest.approx(2.0 * counts[what])


def test_bench_passes_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit) as exc:
        bench_passes.main(["--rows", "64"])
    assert exc.value.code not in (0, None) and "needs a CUDA device" in str(exc.value.code)
    with pytest.raises(SystemExit, match="unknown argument"):
        bench_passes.main(["--block", "8"])


@pytest.mark.parametrize("offset", [0, 4, 8, 12])
@pytest.mark.parametrize("n", [1, 3, 4, 5, 77077, 90250 * 256 + 3])
def test_split_for_vectors(n, offset):
    head, body, tail = split_for_vectors(offset, n)
    assert head + body + tail == n and min(head, body, tail) >= 0
    assert body % 4 == 0 and head <= 3 and tail <= 3
    if body:  # the float4 body starts on a 16-byte boundary
        assert (offset + 4 * head) % 16 == 0
    else:  # too short to reach a boundary and hold a float4 past it
        assert n - head < 4
    assert head == min(n, (16 - offset) % 16 // 4)


def test_split_for_vectors_refuses_a_misaligned_float():
    with pytest.raises(ValueError, match="remainder"):
        split_for_vectors(2, 10)


@pytest.mark.parametrize("shift", [0, 1, 2, 3])
def test_output_shares_the_input_remainder(shift):
    x = torch.zeros(40)[shift:shift + 33].view(3, 11)
    out = _empty_aligned_as(x)
    assert out.shape == x.shape and out.dtype == x.dtype and out.is_contiguous()
    assert out.data_ptr() % 16 == x.data_ptr() % 16


ELEMS = 90250 * 256


def test_mul_bound_is_its_issue_slots():
    # one FMUL a pass and element: 104 x 23,104,000 lane instructions over
    # 132 SMs x 128 lanes at the clock of the 67 TFLOP/s peak (67e12 / 2
    # lanes a second) = 2 x 104 x elems / 67e12, the FLOP bound it replaces
    assert bench_passes.PASS_SASS["mul"]["sass"] == bench_passes.PASS_SASS["mul"]["trip"]
    bound = bench_passes.pass_bound_ms("mul", ELEMS, 104)
    assert bound == pytest.approx(1e3 * 104 * ELEMS / 33.5e12, rel=1e-12)
    assert round(bound, 4) == 0.0717
    parts = bench_passes.pass_bounds("mul", ELEMS, 104)
    assert parts["bytes"] == pytest.approx(1e3 * 8 * ELEMS / 3.35e12) and parts["mufu"] == 0.0


def test_bytes_set_the_bound_at_one_pass():
    for op in ("mul", "tanh", "rsqrt"):
        parts = bench_passes.pass_bounds(op, ELEMS, 1)
        assert max(parts, key=parts.get) == "bytes"
        assert bench_passes.pass_bound_ms(op, ELEMS, 1) == pytest.approx(0.0551737, rel=1e-6)  # 184.8 MB at 3.35 TB/s


def test_mufu_bound_follows_the_mufu_count():
    # 16 MUFU lanes an SM: 132 x 16 x 67e12 / 256 = 4.1875e12 lane results a second
    counts = {"op": {"trip": 8, "sass": 40, "xu": 16}}  # 5 instructions, 2 of them MUFU, an element
    parts = bench_passes.pass_bounds("op", ELEMS, 104, counts)
    assert parts["mufu"] == pytest.approx(1e3 * 2 * 104 * ELEMS / 4.1875e12, rel=1e-12)
    assert parts["issue"] == pytest.approx(1e3 * 5 * 104 * ELEMS / 33.5e12, rel=1e-12)
    assert bench_passes.pass_bound_ms("op", ELEMS, 104, counts) == parts["mufu"]
    counts["op"]["xu"] = 32
    assert bench_passes.pass_bounds("op", ELEMS, 104, counts)["mufu"] == pytest.approx(2 * parts["mufu"])
    # rsqrt: FADD and MUFU.RSQ an element, so the MUFU sets its bound
    rsqrt = bench_passes.pass_bounds("rsqrt", ELEMS, 104)
    assert rsqrt["mufu"] == pytest.approx(1e3 * 104 * ELEMS / 4.1875e12) and rsqrt["mufu"] > rsqrt["issue"]


def test_accounting_price_is_never_below_the_bound():
    # mul: 64 FMUL a trip of 64 element passes, so one pass over ELEMS
    # issues in ELEMS / 33.5e12 s = 0.6897 us; a slope under it is priced there
    issue = 1e3 * ELEMS / 33.5e12
    assert bench_passes.pass_price_ms("mul", 0.000295, ELEMS) == pytest.approx(issue, rel=1e-12)
    assert bench_passes.pass_price_ms("mul", 0.0008, ELEMS) == 0.0008
    # rsqrt: its MUFU.RSQ over 16 lanes an SM sets the floor, not its 2 instructions
    mufu = 1e3 * ELEMS / 4.1875e12
    assert bench_passes.pass_price_ms("rsqrt", 0.0, ELEMS) == pytest.approx(mufu, rel=1e-12)
    # the bytes of a launch are no part of a pass's price
    assert bench_passes.pass_price_ms("add", 0.0, ELEMS) < bench_passes.pass_bound_ms("add", ELEMS, 1)


def _sass(op_id, lines):
    """A function of ``cuobjdump -sass``'s listing, one instruction a line at
    0x10 steps, each followed by its encoding comment."""
    body = "".join(f"        /*{16 * i:04x}*/                   {t} ;                 /* 0x000 */\n"
                   f"                                                                  /* 0x000 */\n"
                   for i, t in enumerate(lines))
    return (f"\t\tFunction : _ZN54_GLOBAL__N__elementwise_passes13passes_kernelILi{op_id}EEEvPKfPfxxxiPy\n"
            f"\t.headerflags\t@\"EF_CUDA_SM90\"\n{body}")


def test_sass_counts_reads_the_main_loop():
    # mul (op 6): an outer tile loop around the main loop of 4 FMUL and its
    # counter, compare and branch, and a smaller remainder loop
    mul = ["LDC R1, c[0x0][0x28]", "S2R R2, SR_TID.X",
           "FMUL R4, R4, 1.0001000165939331055", "FMUL R5, R5, 1.0001000165939331055",  # 0x20: main loop
           "FMUL R4, R4, 1.0001000165939331055", "UIADD3 UR5, UR5, 0x2, URZ",
           "FMUL R5, R5, 1.0001000165939331055", "ISETP.LT.AND P0, PT, R12, UR5, PT",
           "@!P0 BRA 0x20",
           "FMUL R4, R4, 1.0001000165939331055", "IADD3 R3, R3, 0x1, RZ",  # 0x90: remainder
           "ISETP.LE.AND P1, PT, R12, R3, PT", "@!P1 BRA 0x90",
           "STG.E.128 desc[UR16][R12.64], R4", "@!P2 BRA 0x20", "EXIT", "BRA 0x100"]
    # sigmoid_exp (op 2): the division's slow path is a call the common path
    # branches over
    sig = ["LDC R1, c[0x0][0x28]",
           "FFMA R0, -R8, 1.4426950216293334961, -R7", "MUFU.EX2 R7, R0",  # 0x10: main loop
           "ISETP.GT.U32.AND P0, PT, R0, 0x1ffffff, PT", "@P0 BRA 0x80",
           "MOV R2, 0x70", "CALL.REL.NOINC 0x200", "BRA 0xa0",
           "MUFU.RCP R8, R17", "FFMA R8, R8, R7, R8",  # 0x80: the common path
           "BSYNC B1", "UIADD3 UR5, UR5, 0x1, URZ", "ISETP.LT.AND P1, PT, R12, UR5, PT", "@!P1 BRA 0x10",
           "EXIT"]
    counts = bench_passes.sass_counts(_sass(6, mul) + _sass(2, sig), trip=2)
    assert counts == {"sigmoid_exp": {"trip": 2, "sass": 7, "xu": 2}, "mul": {"trip": 2, "sass": 4, "xu": 0}}


def test_pass_sass_table_is_whole():
    assert list(bench_passes.PASS_SASS) == list(OPS)
    trips = {c["trip"] for c in bench_passes.PASS_SASS.values()}
    assert len(trips) == 1 and trips.pop() % 8 == 0  # E registers x 8 passes a trip
    for op, c in bench_passes.PASS_SASS.items():
        assert 0 <= c["xu"] <= c["sass"], op
