"""The per-pass cost probe: plain version against JAX, the wrapper, the slope
fit and the forward kernel's pass accounting.

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
from bio_diffusion_torch.ops.passes import OPS, repeat_op, repeat_op_plain

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
