"""Per-pass cost of elementwise ops on one CUDA card, and what they account for
in the port's forward message-layer kernel.

Usage:
  python -m bio_diffusion_torch.cli.bench_passes [--rows 90250] [--cols 256] [--reps 20]

Counterpart of ``scripts/bench_vpu_passes.py``.  For each of the nine ops of
``ops/passes.py`` it times the probe kernel (``csrc/elementwise_passes.cu``)
over a seeded ``[rows, cols]`` float32 array at k=1, 8, 104 and 208 passes
with CUDA events and fits the slope between 104 and 208, where every op's
passes outlast its bytes: the cost of one pass over the array (a slope that
starts at k=8 takes in passes that run under the memory stream, and for
add and mul falls below what the card can issue).  It prints ns per pass and
Gelem/s per op, and beside each the slope of the plain version between 8 and
104 (one PyTorch call per pass, three for rsqrt and two for the bf16 round
trip), the one PyTorch call that computes one pass
where there is one (the library yardstick at k=1), and each op's bound
(:func:`pass_bound_ms`) from the SASS counts in ``PASS_SASS``, which it
checks against the built library's SASS wherever ``cuobjdump`` is found (a
count that differs raises ``AssertionError``).  It samples the card's SM
clock with ``nvidia-smi`` while it times.

Then it accounts for the forward kernel (``csrc/message_layer.cu``) at QM9
width, bf16, B=250, N=19 (90,250 edge rows): the passes one layer makes (the
products left on the FMA pipes as one op per multiply-add, the exp-form silu
and sigmoids of its 4 stages, the gates over V, the attention, the adds, the
bf16 rounding), each times its op's measured cost a pass (or its bound a
pass, where the measured slope falls below it), and the wide products the
kernel runs on the tensor cores at the card's bf16 peak over the rows its
m16 tiles compute (a bound, not a measurement), against the kernel's own
time on the same card in the same process.  The last line is one JSON object
with the numbers.  Without a CUDA device it exits with an error.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import threading
from typing import Dict, List, Optional, Tuple

K_LO, K_HI, K_TOP = 8, 104, 208
QM9 = dict(s_dim=256, v_dim=32, se=64, ve=16, h1=20, hc=8, num_gcps=3)
# the card's dense bf16 tensor-core peak (NVIDIA H100 SXM data sheet), FLOP/s
PEAK_BF16_FLOP_S = 989e12
# the card's memory rate, B/s, and the SM clock its float32 peak (67 TFLOP/s:
# 132 SMs x 128 FMA lanes x 2 FLOP) implies, Hz; an SM issues 4 warp
# instructions a clock (128 lanes), and its special-function unit (MUFU,
# which also runs the float conversions) takes 16 lanes a clock
PEAK_BYTES_S = 3.35e12
SMS = 132
CLOCK_HZ = 67e12 / (2 * SMS * 128)
SM_LANES_S = SMS * 128 * CLOCK_HZ
XU_LANES_S = SMS * 16 * CLOCK_HZ
# the ops with one PyTorch call for one pass (the library yardstick)
ONE_CALL = ("tanh", "exp", "sigmoid_exp", "sigmoid_tanh", "silu_tanh", "add", "mul")
# per op, read from ``cuobjdump -sass`` of the built csrc/elementwise_passes.cu
# (sass_counts): the element passes of one trip of the kernel's main loop
# (E registers x passes a trip), the SASS instructions that trip issues on
# its common path without the loop's own counter, compare and branch, and of
# them the instructions of the 16-lane unit (MUFU.*, F2F)
PASS_SASS: Dict[str, Dict[str, int]] = {
    "tanh": {"trip": 64, "sass": 1018, "xu": 128},
    "exp": {"trip": 64, "sass": 514, "xu": 64},
    "sigmoid_exp": {"trip": 64, "sass": 1223, "xu": 128},
    "sigmoid_tanh": {"trip": 64, "sass": 1098, "xu": 128},
    "silu_tanh": {"trip": 64, "sass": 1218, "xu": 128},
    "add": {"trip": 64, "sass": 64, "xu": 0},
    "mul": {"trip": 64, "sass": 64, "xu": 0},
    "rsqrt": {"trip": 64, "sass": 128, "xu": 64},
    "cast_roundtrip": {"trip": 64, "sass": 128, "xu": 64},
}


def slope(t_lo: float, t_hi: float, k_lo: int = K_LO, k_hi: int = K_HI) -> float:
    """Time of one pass from the times of launches with k_lo and k_hi passes."""
    return (t_hi - t_lo) / (k_hi - k_lo)


def pass_bounds(op: str, elems: int, k: int, counts: Dict[str, Dict[str, int]] = None) -> Dict[str, float]:
    """The three least times (ms) of one launch of ``k`` passes of ``op``
    over ``elems`` float32 elements: ``bytes`` (each read and written once),
    ``issue`` (its SASS instructions over the SMs' issue rate) and ``mufu``
    (its 16-lane-unit instructions over that unit's rate)."""
    c = (PASS_SASS if counts is None else counts)[op]
    per_elem_pass = elems * k / c["trip"]
    return {"bytes": 1e3 * 8 * elems / PEAK_BYTES_S,
            "issue": 1e3 * c["sass"] * per_elem_pass / SM_LANES_S,
            "mufu": 1e3 * c["xu"] * per_elem_pass / XU_LANES_S}


def pass_bound_ms(op: str, elems: int, k: int, counts: Dict[str, Dict[str, int]] = None) -> float:
    """The least time (ms) of one launch of ``k`` passes of ``op`` over
    ``elems`` elements: the largest of :func:`pass_bounds`."""
    return max(pass_bounds(op, elems, k, counts).values())


def pass_price_ms(op: str, slope_ms: float, elems: int) -> float:
    """The cost (ms) the accounting gives one pass of ``op`` over ``elems``
    elements: its measured slope, or the least time the card can issue or
    run the pass in where the slope falls below that."""
    parts = pass_bounds(op, elems, 1)
    return max(slope_ms, parts["issue"], parts["mufu"])


_SASS_LINE = re.compile(r"^\s+/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", re.M)
_BRANCH = re.compile(r"^(@!?P\d\s+)?BRA(?:\.\S+)?\s+(?:`\()?0x([0-9a-f]+)")


def _main_loop_path(ins: List[Tuple[int, str]]) -> List[str]:
    """The instructions one trip of a kernel's main pass loop issues: the
    innermost loop (a backward branch enclosing no other) of the widest
    span, walked from its head to its branch along the common path (a
    forward branch is taken where the code it skips makes a call, the
    arithmetic's slow path)."""
    at = {a: i for i, (a, _) in enumerate(ins)}
    loops = []
    for i, (addr, txt) in enumerate(ins):
        m = _BRANCH.match(txt)
        if m and int(m.group(2), 16) < addr:
            loops.append((at[int(m.group(2), 16)], i))
    inner = [(h, e) for h, e in loops if not any((h2, e2) != (h, e) and h <= h2 and e2 <= e for h2, e2 in loops)]
    head, end = max(inner, key=lambda l: l[1] - l[0])
    path, i = [], head
    while i <= end:
        txt = ins[i][1]
        path.append(txt)
        m = _BRANCH.match(txt)
        if m and i < end:
            target = at[int(m.group(2), 16)]
            if not m.group(1) or any("CALL" in t for _, t in ins[i + 1:target]):
                i = target
                continue
        i += 1
    return path


def sass_counts(sass: str, trip: int) -> Dict[str, Dict[str, int]]:
    """Per op, from ``cuobjdump -sass`` of the pass-probe library: ``trip``
    (the library's element passes a trip), ``sass`` (the
    instructions of a trip's common path less the loop's own: the backward
    branch, its compare and the uniform-datapath counter) and ``xu`` (of
    them, MUFU.* and F2F)."""
    from bio_diffusion_torch.ops.passes import OPS

    out = {}
    for func in re.split(r"^\s*Function : ", sass, flags=re.M)[1:]:
        m = re.search(r"passes_kernelILi(\d+)E", func.split(None, 1)[0])
        if not m:
            continue
        path = _main_loop_path([(int(a, 16), t) for a, t in _SASS_LINE.findall(func)])
        pred = (_BRANCH.match(path[-1]).group(1) or "").strip().lstrip("@!")
        control = 1 + sum(1 for t in path[:-1] if t.startswith("U") or
                          (t.startswith("ISETP") and t.split()[1].rstrip(",") == pred))
        op = OPS[int(m.group(1))]
        out[op] = {"trip": trip, "sass": len(path) - control,
                   "xu": sum(1 for t in path if re.match(r"(@!?P\d\s+)?(MUFU|F2F)\b", t))}
    return {op: out[op] for op in OPS if op in out}


def find_cuobjdump() -> Optional[str]:
    """The toolkit's ``cuobjdump``, or the copy in Triton's package; None
    where neither is installed."""
    candidates = [os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump"),
                  shutil.which("cuobjdump")]
    try:
        import triton

        candidates.append(os.path.join(os.path.dirname(triton.__file__), "backends", "nvidia", "bin", "cuobjdump"))
    except ImportError:
        pass
    return next((c for c in candidates if c and os.path.isfile(c) and os.access(c, os.X_OK)), None)


def check_sass() -> Optional[Dict[str, Dict[str, int]]]:
    """The counts of the loaded pass-probe library's SASS, held against
    ``PASS_SASS`` (``AssertionError`` where one differs); None where no
    ``cuobjdump`` is found.  The match is exact: nvcc gives the same SASS for
    the same source and toolkit, and an edit or another toolkit that moves a
    count (register allocation moved sigmoid_exp's by one between edits)
    moves the bound, so the table takes the new counts."""
    import ctypes

    from bio_diffusion_torch.ops.build import load_library

    tool = find_cuobjdump()
    if tool is None:
        return None
    lib = load_library("elementwise_passes")
    lib.elementwise_passes_trip.restype = ctypes.c_int
    sass = subprocess.run([tool, "-sass", lib._name], check=True, capture_output=True, text=True).stdout
    counts = sass_counts(sass, lib.elementwise_passes_trip())
    if counts != PASS_SASS:
        raise AssertionError(f"the pass probe's SASS counts {counts} differ from PASS_SASS {PASS_SASS}")
    return counts


class ClockSampler:
    """Reads the first card's SM clock (MHz) with ``nvidia-smi`` every
    ``period`` s while the block runs; ``mhz`` stays empty without it."""

    def __init__(self, period: float = 0.5):
        self.period, self.mhz = period, []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self) -> None:
        cmd = ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"]
        while not self._stop.is_set():
            try:
                out = subprocess.run(cmd, capture_output=True, text=True, timeout=10).stdout.split()
            except (OSError, subprocess.SubprocessError):
                return
            if out and out[0].isdigit():
                self.mhz.append(int(out[0]))
            self._stop.wait(self.period)

    def __enter__(self):
        if shutil.which("nvidia-smi"):
            self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join()


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


def layer_inputs(torch, b: int, n: int, dtype, seed: int = 0, widths=None):
    """``(s, v, epack, g1, chain)`` of one full-width layer on the card
    (``widths``: a dict of ``s_dim``, ``v_dim``, ``se``, ``ve``, QM9's by
    default): weights and inputs drawn from ``seed``."""
    from bio_diffusion_torch.config.schema import LayerConfig, ModuleConfig
    from bio_diffusion_torch.models.gcpnet import GCPMessagePassing
    from bio_diffusion_torch.ops import message_layer as ml
    from bio_diffusion_torch.train.torch_import import init_random_weights

    widths = widths or QM9
    s_dim, v_dim, se, ve = widths["s_dim"], widths["v_dim"], widths["se"], widths["ve"]
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
    """op -> kernel times at 1, K_LO, K_HI and K_TOP and plain times at K_LO
    and K_HI, their per-pass slopes (ms; the kernel's from K_HI to K_TOP, the
    plain version's from K_LO to K_HI) and the one PyTorch call for one pass
    (``library_k1_ms``, None where no one call computes the op)."""
    from bio_diffusion_torch.ops.passes import OPS, PLAIN, repeat_op, repeat_op_plain

    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(rows, cols, generator=gen, device="cuda")
    out = {}
    for op in OPS:
        r = {"kernel_k1_ms": _time_ms(torch, lambda: repeat_op(x, op, 1), reps),
             "library_k1_ms": _time_ms(torch, lambda: PLAIN[op](x), reps) if op in ONE_CALL else None}
        for name, fn, ks in (("kernel", repeat_op, (K_LO, K_HI, K_TOP)), ("plain", repeat_op_plain, (K_LO, K_HI))):
            for k in ks:
                r[f"{name}_k{k}_ms"] = _time_ms(torch, lambda: fn(x, op, k), reps)
            r[f"{name}_pass_ms"] = slope(r[f"{name}_k{ks[-2]}_ms"], r[f"{name}_k{ks[-1]}_ms"], ks[-2], ks[-1])
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
    sass = check_sass()
    print(f"# {torch.cuda.get_device_name(0)}; probe [{rows}, {cols}] float32, k=1, {K_LO}, {K_HI} and {K_TOP} "
          f"(the kernel's slope from {K_HI} to {K_TOP}, the plain version's from {K_LO} to {K_HI}), "
          f"best of 3 x {reps} launches (CUDA events); SASS counts "
          f"{'read and held against PASS_SASS' if sass else 'from PASS_SASS (no cuobjdump found)'}")
    with ClockSampler() as clocks:
        results = probe(torch, rows, cols, reps)
    for op, r in results.items():
        k_ns, p_ns = r["kernel_pass_ms"] * 1e6, r["plain_pass_ms"] * 1e6
        parts = pass_bounds(op, elems, 1)
        r["bound_ns_per_pass"] = 1e6 * max(parts["issue"], parts["mufu"])
        r["bound_by"] = "issue" if parts["issue"] >= parts["mufu"] else "mufu"
        r["bound_k104_ms"] = pass_bound_ms(op, elems, K_HI)
        r["share_of_bound"] = r["bound_k104_ms"] / r[f"kernel_k{K_HI}_ms"]
        r["sass"] = (sass or PASS_SASS)[op]
        r["price_ns_per_pass"] = 1e6 * pass_price_ms(op, r["kernel_pass_ms"], elems)
        lib = f"{r['library_k1_ms']:.4f} ms" if r["library_k1_ms"] is not None else "none"
        print(f"{op:>14}: kernel {k_ns:10.1f} ns/pass ({elems / max(k_ns, 1e-9):8.1f} Gelem/s), bound "
              f"{r['bound_ns_per_pass']:8.1f} ({r['bound_by']}); plain {p_ns:10.1f} ns/pass  "
              f"[kernel k=1: {r['kernel_k1_ms']:.4f} ms (one PyTorch call {lib}), k={K_LO}: "
              f"{r[f'kernel_k{K_LO}_ms']:.4f} ms, k={K_HI}: {r[f'kernel_k{K_HI}_ms']:.4f} ms against a bound of "
              f"{r['bound_k104_ms']:.4f} ms, {100 * r['share_of_bound']:.1f}%, k={K_TOP}: "
              f"{r[f'kernel_k{K_TOP}_ms']:.4f} ms]")
    clock = (f"{min(clocks.mhz)}-{max(clocks.mhz)} MHz over {len(clocks.mhz)} readings" if clocks.mhz
             else "not read")
    print(f"# SM clock while timing (nvidia-smi): {clock}")

    b, n = 250, 19
    layer_rows = b * n * n
    items = forward_passes(**QM9, n=n, bf16=True)
    per_pass = {op: 1e-6 * r["price_ns_per_pass"] for op, r in results.items()}
    at_bound = [op for op, r in results.items() if r["price_ns_per_pass"] > 1e6 * r["kernel_pass_ms"]]
    per_pass["mma"] = 2e3 * elems / PEAK_BF16_FLOP_S  # one multiply-add per element at the peak
    acct = account(items, per_pass, elems, layer_rows, QM9["s_dim"])
    layer_ms = message_layer_ms(torch, b, n, torch.bfloat16, reps)
    total = sum(acct.values())
    print(f"\n# forward message layer, QM9 width, bf16, B={b} N={n} ({layer_rows} edge rows): "
          f"passes x measured cost per pass"
          f"{' (at the bound a pass for ' + ', '.join(at_bound) + ')' if at_bound else ''}")
    for (what, op, count), ms in zip(items, acct.values()):
        print(f"#   {what:>58}: {count:9.2f} {op:>14} passes {ms * 1e3:10.1f} us")
    print(f"#   {'total':>58}: {total * 1e3:.1f} us; the kernel measured {layer_ms * 1e3:.1f} us "
          f"({100 * total / layer_ms:.1f}% accounted)")
    result = {"device": torch.cuda.get_device_name(0), "rows": rows, "cols": cols, "reps": reps,
              "per_pass": results, "accounting_ms": acct, "accounted_ms": total,
              "message_layer_ms": layer_ms, "priced_at_bound": at_bound, "clocks_sm_mhz": clocks.mhz,
              "sass_checked": sass is not None}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
