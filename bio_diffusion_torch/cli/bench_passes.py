"""Per-pass cost of elementwise ops on one CUDA card, and what they account for
in the port's forward message-layer kernel.

Usage:
  python -m bio_diffusion_torch.cli.bench_passes [--rows 90250] [--cols 256] [--reps 20]

Counterpart of ``scripts/bench_vpu_passes.py``.  For each of the nine ops of
``ops/passes.py`` it times the probe kernel (``csrc/elementwise_passes.cu``)
over a seeded ``[rows, cols]`` float32 array at k=8 and k=104 passes with CUDA
events and fits the slope: the cost of one pass over the array.  It prints ns
per pass and Gelem/s per op, and beside each the slope of the plain version
(one PyTorch call per pass, three for rsqrt and two for the bf16 round trip:
the library yardstick).

Then it accounts for the forward kernel (``csrc/message_layer.cu``) at QM9
width, bf16, B=250, N=19 (90,250 edge rows): the passes one layer makes (the
products left on the FMA pipes as one op per multiply-add, the exp-form silu
and sigmoids of its 4 stages, the gates over V, the attention, the adds, the
bf16 rounding), each times its op's measured cost, and the wide products the
kernel runs on the tensor cores at the card's bf16 peak over the rows its
m16 tiles compute (a bound, not a measurement), against the kernel's own
time on the same card in the same process.  The last line is one JSON object
with the numbers.  Without a CUDA device it exits with an error.
"""

from __future__ import annotations

import json
import sys
from typing import Dict, List, Tuple

K_LO, K_HI = 8, 104
QM9 = dict(s_dim=256, v_dim=32, se=64, ve=16, h1=20, hc=8, num_gcps=3)
# the card's dense bf16 tensor-core peak (NVIDIA H100 SXM data sheet), FLOP/s
PEAK_BF16_FLOP_S = 989e12


def slope(t_lo: float, t_hi: float, k_lo: int = K_LO, k_hi: int = K_HI) -> float:
    """Time of one pass from the times of launches with k_lo and k_hi passes."""
    return (t_hi - t_lo) / (k_hi - k_lo)


def wide_macs_per_row(s_dim: int, v_dim: int, se: int, h1: int, hc: int, num_gcps: int) -> int:
    """Multiply-adds per edge row of the products the bf16 kernel runs on the
    tensor cores: the first GCP's [e | vnorm | schid] @ wsx and silu @ wg, and
    each chain stage's merged @ wsc and silu @ wg."""
    return (se + h1 + 9) * s_dim + s_dim * v_dim + num_gcps * ((s_dim + hc + 9) * s_dim + s_dim * v_dim)


def mma_rows(n: int) -> int:
    """Rows the tensor-core products compute for the ``n`` target rows of a
    (molecule, source node): tiles of 32 rows, each as m16 tiles."""
    return sum(-(-min(32, n - j0) // 16) * 16 for j0 in range(0, n, 32))


def forward_passes(s_dim: int, v_dim: int, se: int, ve: int, h1: int, hc: int, num_gcps: int,
                   n: int, bf16: bool = True) -> List[Tuple[str, str, float]]:
    """The passes one forward message layer over molecules of ``n`` nodes
    makes per edge row, as ``(what, op, count)`` with ``count`` in passes over
    ``[rows, S]``.  A product's multiply-add on the FMA pipes counts as one
    ``mul``; in bf16 the wide products run on the tensor cores and count as
    ``mma`` passes over the rows their m16 tiles compute.  The kernel's silu
    is ``x * sigmoid(x)`` with the exp-form sigmoid."""
    from bio_diffusion_torch.ops.message_layer import layer_macs_per_row

    stages = 1 + num_gcps
    s = float(s_dim)
    v3 = 3 * v_dim / s
    macs = layer_macs_per_row(s_dim, v_dim, se, ve, h1, hc, num_gcps)
    wide = wide_macs_per_row(s_dim, v_dim, se, h1, hc, num_gcps) if bf16 else 0
    items = [
        ("products (FMA)", "mul", (macs - wide) / s),
        ("silu(s2): sigmoid [rows, S] x stages", "sigmoid_exp", stages),
        ("silu(s2): x * sigmoid [rows, S] x stages", "mul", stages),
        ("gate sigmoid [rows, V] x stages", "sigmoid_exp", stages * v_dim / s),
        ("attention sigmoid [rows, 1]", "sigmoid_exp", 1 / s),
        ("bias adds [rows, S + V] x stages", "add", stages * (1 + v_dim / s)),
        ("residual adds [rows, S + 3V] x chain stages", "add", num_gcps * (1 + v3)),
        ("vector gating v * gate [rows, 3V] x stages", "mul", stages * v3),
        ("vector norms sqrt [rows, H]", "rsqrt", (h1 + num_gcps * hc) / s),
        ("attention scale and mask, sum over targets [rows, S + 3V]", "mul", 1 + v3),
        ("sum over targets [rows, S + 3V]", "add", 1 + v3),
    ]
    if bf16:
        items.insert(1, ("products (tensor cores, at the bf16 peak)", "mma", wide / s * mma_rows(n) / n))
        # every value rounded to the compute dtype: silu, gate, vh, norms and
        # frames, vu and vu * gate per stage; v and s residual sums per chain
        # stage; the attention scale and the summed terms
        per_stage = s_dim + v_dim + 3 * 2 * v_dim + 9
        rounded = (per_stage + 4 * h1) + num_gcps * (per_stage + 4 * hc + 3 * v_dim + s_dim) + 1 + s_dim + 3 * v_dim
        items.append(("bf16 rounding", "cast_roundtrip", rounded / s))
    return items


def account(items: List[Tuple[str, str, float]], per_pass_ms: Dict[str, float], probe_elems: int,
            layer_rows: int, s_dim: int) -> Dict[str, float]:
    """ms of each item for ``layer_rows`` edge rows, from the measured cost of
    one pass over ``probe_elems`` elements."""
    scale = layer_rows * s_dim / probe_elems
    return {what: count * per_pass_ms[op] * scale for what, op, count in items}


def _time_ms(torch, fn, reps: int) -> float:
    """Best of three runs of ``reps`` calls each, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / reps)
    return best


def layer_inputs(torch, b: int, n: int, dtype, seed: int = 0):
    """``(s, v, epack, g1, chain)`` of one full-width layer on the card:
    weights and inputs drawn from ``seed``."""
    from bio_diffusion_torch.config.schema import LayerConfig, ModuleConfig
    from bio_diffusion_torch.models.gcpnet import GCPMessagePassing
    from bio_diffusion_torch.ops import message_layer as ml
    from bio_diffusion_torch.train.torch_import import init_random_weights

    s_dim, v_dim, se, ve = QM9["s_dim"], QM9["v_dim"], QM9["se"], QM9["ve"]
    mp = GCPMessagePassing((s_dim, v_dim), (se, ve), ModuleConfig(), LayerConfig())
    init_random_weights(mp, seed)
    g1, chain = ml.detached(ml.pack_message_stack(mp.to("cuda"), s_dim, v_dim, ve, dtype))
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    ones = torch.ones(b, n * n, 1, device="cuda", dtype=dtype)
    epack = torch.cat([randn(b, n * n, se), randn(b, n * n, 3 * ve), randn(b, n * n, 9), ones], dim=-1)
    return randn(b, n, s_dim), randn(b, n, 3 * v_dim), epack, g1, chain


def message_layer_ms(torch, b: int, n: int, dtype, reps: int, seed: int = 0) -> float:
    """The forward kernel's time on one full-width layer with weights and inputs
    drawn from ``seed``."""
    from bio_diffusion_torch.ops import message_layer as ml

    s, v, epack, g1, chain = layer_inputs(torch, b, n, dtype, seed)
    return _time_ms(torch, lambda: ml.fused_message_layer(s, v, epack, g1, chain, ve_dim=QM9["ve"]), reps)


def probe(torch, rows: int, cols: int, reps: int) -> Dict[str, Dict[str, float]]:
    """op -> kernel and plain times at K_LO and K_HI and their per-pass slopes (ms)."""
    from bio_diffusion_torch.ops.passes import OPS, repeat_op, repeat_op_plain

    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(rows, cols, generator=gen, device="cuda")
    out = {}
    for op in OPS:
        r = {}
        for name, fn in (("kernel", repeat_op), ("plain", repeat_op_plain)):
            for k in (K_LO, K_HI):
                r[f"{name}_k{k}_ms"] = _time_ms(torch, lambda: fn(x, op, k), reps)
            r[f"{name}_pass_ms"] = slope(r[f"{name}_k{K_LO}_ms"], r[f"{name}_k{K_HI}_ms"])
        out[op] = r
    return out


def main(argv=None) -> Dict[str, object]:
    import torch

    argv = list(sys.argv[1:] if argv is None else argv)
    opts = {"--rows": 90250, "--cols": 256, "--reps": 20}
    while argv:
        flag = argv.pop(0)
        if flag not in opts or not argv:
            print(__doc__.strip())
            raise SystemExit(0 if flag == "--help" else f"unknown argument {flag!r}")
        opts[flag] = int(argv.pop(0))
    rows, cols, reps = opts["--rows"], opts["--cols"], opts["--reps"]
    if not torch.cuda.is_available():
        raise SystemExit("bench_passes needs a CUDA device")
    elems = rows * cols
    print(f"# {torch.cuda.get_device_name(0)}; probe [{rows}, {cols}] float32, k={K_LO} and k={K_HI}, "
          f"best of 3 x {reps} launches (CUDA events)")
    results = probe(torch, rows, cols, reps)
    for op, r in results.items():
        k_ns, p_ns = r["kernel_pass_ms"] * 1e6, r["plain_pass_ms"] * 1e6
        print(f"{op:>14}: kernel {k_ns:10.1f} ns/pass ({elems / max(k_ns, 1e-9):8.1f} Gelem/s); "
              f"plain {p_ns:10.1f} ns/pass ({elems / max(p_ns, 1e-9):7.1f} Gelem/s)  "
              f"[kernel k={K_LO}: {r[f'kernel_k{K_LO}_ms']:.4f} ms, k={K_HI}: {r[f'kernel_k{K_HI}_ms']:.4f} ms]")

    b, n = 250, 19
    layer_rows = b * n * n
    items = forward_passes(**QM9, n=n, bf16=True)
    per_pass = {op: r["kernel_pass_ms"] for op, r in results.items()}
    per_pass["mma"] = 2e3 * elems / PEAK_BF16_FLOP_S  # one multiply-add per element at the peak
    acct = account(items, per_pass, elems, layer_rows, QM9["s_dim"])
    layer_ms = message_layer_ms(torch, b, n, torch.bfloat16, reps)
    total = sum(acct.values())
    print(f"\n# forward message layer, QM9 width, bf16, B={b} N={n} ({layer_rows} edge rows): "
          f"passes x measured cost per pass")
    for (what, op, count), ms in zip(items, acct.values()):
        print(f"#   {what:>58}: {count:9.2f} {op:>14} passes {ms * 1e3:10.1f} us")
    print(f"#   {'total':>58}: {total * 1e3:.1f} us; the kernel measured {layer_ms * 1e3:.1f} us "
          f"({100 * total / layer_ms:.1f}% accounted)")
    result = {"device": torch.cuda.get_device_name(0), "rows": rows, "cols": cols, "reps": reps,
              "per_pass": results, "accounting_ms": acct, "accounted_ms": total,
              "message_layer_ms": layer_ms}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
