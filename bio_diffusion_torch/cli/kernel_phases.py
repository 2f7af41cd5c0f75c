"""Where a message-layer kernel's time goes, phase by phase, on one CUDA card.

Usage:
  python -m bio_diffusion_torch.cli.kernel_phases [--kernel fwd|bwd] [--b B] [--n N]
      [--precision bf16|fp32]

``--kernel fwd`` (the default; B=250, N=19, bf16) probes the forward kernel
(``csrc/message_layer.cu``), ``--kernel bwd`` (B=64, N=29, fp32) the
backward's row kernel (``bwd_rows_kernel`` in ``csrc/message_layer_bwd.cu``).
The source is built with ``-DPHASE_PROBE`` (a library of its own beside the
normal one): thread 0 of every block reads ``clock64()`` at each of the
kernel's phase marks, one after each block barrier and one at the kernel's
(forward) or the tile's (backward) end (``csrc/message_layer_common.cuh``),
and adds the cycles since the previous mark to that phase's device counter.
A barrier ends each phase, so a phase's cycles are those of its slowest warp.
The backward walks the targets in tiles of 16 rows, and every tile adds to
the same counters.  Runs one layer at full QM9 width (weights, inputs and
cotangents drawn from a seed; the forward takes N <= 32, one tile of target
rows per block) and prints each phase's SM cycles per block and its share;
the last line is one JSON object.  Without a CUDA device it exits with an
error.
"""

from __future__ import annotations

import ctypes
import json
import sys
from typing import Dict, List

from bio_diffusion_torch.cli.bench_passes import QM9

SLOTS = 64  # PHASE_SLOTS of csrc/message_layer_common.cuh
SOURCES = {"fwd": ("message_layer", "fused_message_layer"),
           "bwd": ("message_layer_bwd", "fused_message_layer_bwd")}
DEFAULTS = {"fwd": ("250", "19", "bf16"), "bwd": ("64", "29", "fp32")}


def phase_names(num_gcps: int, kernel: str = "fwd") -> List[str]:
    """The phases of one block's tile of target rows, in the order of its
    phase marks: each ends at a block barrier (the last at the kernel's or
    the tile's end).  (FMA) products run on the FMA pipes, (mma) ones on the
    tensor cores in bf16."""
    if kernel == "bwd":
        return bwd_phase_names(num_gcps)
    names = ["zero the sums", "load the edge tile", "xi @ wve (FMA)", "norms, frames",
             "[e|vnorm|schid] @ wsx (mma)", "silu @ wg (mma)", "vh @ wu (FMA), copy"]
    for g in range(num_gcps):
        names += [f"stage {g}: v @ wcomb (FMA)", f"stage {g}: norms, frames",
                  f"stage {g}: merged @ wsc (mma)", f"stage {g}: silu @ wg (mma)",
                  f"stage {g}: vh @ wu_bd (FMA), residual"]
    return names + ["attention", "sum over targets", "store"]


def bwd_phase_names(num_gcps: int) -> List[str]:
    """The backward row kernel's phases of one tile: the recompute, the
    attention, the reverse walk over the stages, the first GCP's backward.
    A product written ``a @ w^T`` reads the transposed weight."""
    names = ["tile start (the previous tile's tail)", "load the edge tile", "xi @ wve",
             "norms, frames", "[e|vnorm|schid] @ wsx", "silu @ wg", "vh @ wu, copy"]
    for g in range(num_gcps):
        names += [f"fwd stage {g}: v @ wcomb", f"fwd stage {g}: norms, frames",
                  f"fwd stage {g}: merged @ wsc", f"fwd stage {g}: silu @ wg",
                  f"fwd stage {g}: vh @ wu_bd, residual"]
    names += ["attention logit, s_fin", "d attention, d mask", "ds, dv of the chain's output"]
    for g in reversed(range(num_gcps)):
        names += [f"bwd stage {g}: d gate, d vu", f"bwd stage {g}: d zg @ wg^T -> d s2",
                  f"bwd stage {g}: d s2 @ wsc^T, d vu @ wu_bd^T", f"bwd stage {g}: norms bwd",
                  f"bwd stage {g}: d vhd @ wcomb^T"]
    return names + ["gcp1: d gate, d vu", "gcp1: d zg @ wg^T -> d s2",
                    "gcp1: d s2 @ wsx^T, d vu @ wu^T", "gcp1: norms bwd",
                    "gcp1: d vhd @ wve^T, stores (thread 0)"]


def build_probe(kernel: str = "fwd") -> ctypes.CDLL:
    """The forward kernel's or the backward's source built with its phase marks."""
    from bio_diffusion_torch.ops import build

    path, _ = build.compile_source(build.SOURCE_DIR / f"{SOURCES[kernel][0]}.cu", defines=("PHASE_PROBE",))
    lib = ctypes.CDLL(str(path))
    lib.phases_read.argtypes, lib.phases_read.restype = [ctypes.POINTER(ctypes.c_ulonglong)], ctypes.c_int
    lib.phases_reset.argtypes, lib.phases_reset.restype = [], ctypes.c_int
    return lib


def measure(torch, b: int, n: int, dtype, seed: int = 0, kernel: str = "fwd") -> Dict[str, float]:
    """Phase name -> SM cycles per block of one probed launch."""
    from bio_diffusion_torch.cli.bench_passes import layer_inputs
    from bio_diffusion_torch.ops import build
    from bio_diffusion_torch.ops import message_layer as ml

    lib = build_probe(kernel)
    args = layer_inputs(torch, b, n, dtype, seed)
    if kernel == "bwd":
        gen = torch.Generator(device="cuda").manual_seed(seed + 1)
        args += ((torch.randn(args[0].shape, generator=gen, device="cuda").to(dtype),
                  torch.randn(args[1].shape, generator=gen, device="cuda").to(dtype)),)
    name, fn = SOURCES[kernel][0], getattr(ml, SOURCES[kernel][1])
    counters = (ctypes.c_ulonglong * SLOTS)()
    with build.library_override(name, lib):
        fn(*args, ve_dim=QM9["ve"])  # warm-up
        torch.cuda.synchronize()
        if lib.phases_reset() != 0:
            raise RuntimeError("could not reset the phase counters")
        fn(*args, ve_dim=QM9["ve"])
        torch.cuda.synchronize()
    if lib.phases_read(counters) != 0:
        raise RuntimeError("could not read the phase counters")
    names = phase_names(QM9["num_gcps"], kernel)
    if counters[len(names) - 1] == 0 or any(counters[len(names):]):
        raise RuntimeError(f"the kernel's phase marks do not match the {len(names)} named phases")
    return {name: counters[i] / (b * n) for i, name in enumerate(names)}


def main(argv=None) -> Dict[str, object]:
    import torch

    argv = list(sys.argv[1:] if argv is None else argv)
    opts = {"--kernel": "fwd", "--b": None, "--n": None, "--precision": None}
    while argv:
        flag = argv.pop(0)
        if flag not in opts or not argv:
            print(__doc__.strip())
            raise SystemExit(0 if flag == "--help" else f"unknown argument {flag!r}")
        opts[flag] = argv.pop(0)
    kernel = opts["--kernel"]
    if kernel not in SOURCES:
        raise SystemExit(f"--kernel is fwd or bwd, not {kernel!r}")
    for flag, default in zip(("--b", "--n", "--precision"), DEFAULTS[kernel]):
        opts[flag] = opts[flag] or default
    b, n = int(opts["--b"]), int(opts["--n"])
    dtypes = {"bf16": torch.bfloat16, "fp32": torch.float32}
    if opts["--precision"] not in dtypes:
        raise SystemExit(f"--precision is bf16 or fp32, not {opts['--precision']!r}")
    if kernel == "fwd" and not 1 <= n <= 32:
        raise SystemExit("kernel_phases takes N <= 32 (one tile of target rows per block)")
    if not torch.cuda.is_available():
        raise SystemExit("kernel_phases needs a CUDA device")
    phases = measure(torch, b, n, dtypes[opts["--precision"]], kernel=kernel)
    total = sum(phases.values())
    what = {"fwd": "forward message layer", "bwd": "backward row kernel"}[kernel]
    print(f"# {torch.cuda.get_device_name(0)}; {what}, QM9 width, {opts['--precision']}, "
          f"B={b} N={n}: SM cycles per block between block barriers (thread 0's clock64)")
    for name, cycles in phases.items():
        print(f"#   {name:>48}: {cycles:10.0f} cycles {100 * cycles / total:5.1f}%")
    print(f"#   {'total':>48}: {total:10.0f} cycles")
    result = {"device": torch.cuda.get_device_name(0), "kernel": kernel, "b": b, "n": n,
              "precision": opts["--precision"], "cycles_per_block": phases,
              "total_cycles_per_block": total}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
