"""Where the forward message-layer kernel's time goes, phase by phase, on one
CUDA card.

Usage:
  python -m bio_diffusion_torch.cli.kernel_phases [--b 250] [--n 19] [--precision bf16|fp32]

Builds ``csrc/message_layer.cu`` with ``-DPHASE_PROBE`` (a library of its
own beside the normal one): thread 0 of every block reads ``clock64()`` at
each of the kernel's phase marks, one after each block barrier and one at the
kernel's end (``csrc/message_layer_common.cuh``), and adds the cycles since
the previous mark to that phase's device counter.  A barrier ends each phase,
so a phase's cycles are those of its slowest warp.  Runs one layer at full
QM9 width (weights and inputs drawn from a seed; N <= 32, one tile of target
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


def phase_names(num_gcps: int) -> List[str]:
    """The phases of one block with one tile of target rows, in the order of
    its phase marks: each ends at a block barrier (the last at the kernel's
    end).  (FMA) products run on the FMA pipes, (mma) ones on the tensor
    cores in bf16."""
    names = ["zero the sums", "load the edge tile", "xi @ wve (FMA)", "norms, frames",
             "[e|vnorm|schid] @ wsx (mma)", "silu @ wg (mma)", "vh @ wu (FMA), copy"]
    for g in range(num_gcps):
        names += [f"stage {g}: v @ wcomb (FMA)", f"stage {g}: norms, frames",
                  f"stage {g}: merged @ wsc (mma)", f"stage {g}: silu @ wg (mma)",
                  f"stage {g}: vh @ wu_bd (FMA), residual"]
    return names + ["attention", "sum over targets", "store"]


def build_probe() -> ctypes.CDLL:
    """The forward kernel built with its phase marks."""
    from bio_diffusion_torch.ops import build

    path, _ = build.compile_source(build.SOURCE_DIR / "message_layer.cu", defines=("PHASE_PROBE",))
    lib = ctypes.CDLL(str(path))
    lib.phases_read.argtypes, lib.phases_read.restype = [ctypes.POINTER(ctypes.c_ulonglong)], ctypes.c_int
    lib.phases_reset.argtypes, lib.phases_reset.restype = [], ctypes.c_int
    return lib


def measure(torch, b: int, n: int, dtype, seed: int = 0) -> Dict[str, float]:
    """Phase name -> SM cycles per block of one probed launch."""
    from bio_diffusion_torch.cli.bench_passes import layer_inputs
    from bio_diffusion_torch.ops import build
    from bio_diffusion_torch.ops import message_layer as ml

    lib = build_probe()
    s, v, epack, g1, chain = layer_inputs(torch, b, n, dtype, seed)
    counters = (ctypes.c_ulonglong * SLOTS)()
    with build.library_override("message_layer", lib):
        ml.fused_message_layer(s, v, epack, g1, chain, ve_dim=QM9["ve"])  # warm-up
        torch.cuda.synchronize()
        if lib.phases_reset() != 0:
            raise RuntimeError("could not reset the phase counters")
        ml.fused_message_layer(s, v, epack, g1, chain, ve_dim=QM9["ve"])
        torch.cuda.synchronize()
    if lib.phases_read(counters) != 0:
        raise RuntimeError("could not read the phase counters")
    names = phase_names(QM9["num_gcps"])
    if counters[len(names) - 1] == 0 or any(counters[len(names):]):
        raise RuntimeError(f"the kernel's phase marks do not match the {len(names)} named phases")
    return {name: counters[i] / (b * n) for i, name in enumerate(names)}


def main(argv=None) -> Dict[str, object]:
    import torch

    argv = list(sys.argv[1:] if argv is None else argv)
    opts = {"--b": "250", "--n": "19", "--precision": "bf16"}
    while argv:
        flag = argv.pop(0)
        if flag not in opts or not argv:
            print(__doc__.strip())
            raise SystemExit(0 if flag == "--help" else f"unknown argument {flag!r}")
        opts[flag] = argv.pop(0)
    b, n = int(opts["--b"]), int(opts["--n"])
    dtypes = {"bf16": torch.bfloat16, "fp32": torch.float32}
    if opts["--precision"] not in dtypes:
        raise SystemExit(f"--precision is bf16 or fp32, not {opts['--precision']!r}")
    if not 1 <= n <= 32:
        raise SystemExit("kernel_phases takes N <= 32 (one tile of target rows per block)")
    if not torch.cuda.is_available():
        raise SystemExit("kernel_phases needs a CUDA device")
    phases = measure(torch, b, n, dtypes[opts["--precision"]])
    total = sum(phases.values())
    print(f"# {torch.cuda.get_device_name(0)}; forward message layer, QM9 width, {opts['--precision']}, "
          f"B={b} N={n}: SM cycles per block between block barriers (thread 0's clock64)")
    for name, cycles in phases.items():
        print(f"#   {name:>40}: {cycles:10.0f} cycles {100 * cycles / total:5.1f}%")
    print(f"#   {'total':>40}: {total:10.0f} cycles")
    result = {"device": torch.cuda.get_device_name(0), "b": b, "n": n, "precision": opts["--precision"],
              "cycles_per_block": phases, "total_cycles_per_block": total}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
