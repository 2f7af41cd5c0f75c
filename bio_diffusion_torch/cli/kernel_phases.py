"""Where a message-layer kernel's time goes, phase by phase, on one CUDA card.

Usage:
  python -m bio_diffusion_torch.cli.kernel_phases [--kernel fwd|bwd] [--b B] [--n N]
      [--precision bf16|fp32] [--qm9-sizes SEED]

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

The forward computes only the edge rows its mask keeps, so it also counts,
over the grid, the rows its products computed (a block's kept targets in
tiles of 32, the last rounded up to the 8 rows a thread owns) and the rows
the grid covers (N a block), and prints their ratio.  ``--qm9-sizes SEED``
draws the B molecules' sizes from the QM9 size histogram (a numpy generator
seeded with SEED) and pads them as ``train/sampling.py::sample_molecules``
pads a batch (N = the largest size rounded up to 2, at most QM9's largest
molecule), the benchmark's sampling traffic; the edge mask is then the
outer product of the node mask, and the ratio is printed beside the one
``expected_rows`` gives for those sizes.  A block with no kept target (a
padded node) passes no phase mark, so the cycles per block are then
averaged over every block of the grid.
"""

from __future__ import annotations

import ctypes
import json
import sys
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from bio_diffusion_torch.cli.bench_passes import QM9

SLOTS = 64  # PHASE_SLOTS of csrc/message_layer_common.cuh
ROW_SLOTS = (SLOTS - 2, SLOTS - 1)  # rows computed, rows covered (PHASE_ROWS)
ROWS, RPT = 32, 8  # the forward's target rows a tile, rows a thread owns in its FMA products
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
    names = ["row list, zero the sums", "load the edge tile", "xi @ wve (FMA)", "norms, frames",
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


def expected_rows(sizes: Sequence[int], pad: int) -> Tuple[int, int]:
    """The forward's ``(computed, covered)`` edge rows for one batch of
    molecules of ``sizes`` atoms padded (at the end) to ``pad``: the block of
    a real node of a molecule of n atoms keeps its n targets and computes
    them in tiles of ``ROWS``, the last rounded up to ``RPT``; a padded
    node's block computes none; every block covers ``pad`` rows."""
    def block(n: int) -> int:
        return n // ROWS * ROWS + -(-(n % ROWS) // RPT) * RPT

    return sum(int(n) * block(int(n)) for n in sizes), len(sizes) * pad * pad


def qm9_batch(b: int, seed: int) -> Tuple[np.ndarray, int]:
    """``b`` molecule sizes drawn from the QM9 histogram and the batch's
    padded size, as ``sample_molecules`` pads it."""
    from bio_diffusion_torch.data.dataset_info import QM9_WITH_H
    from bio_diffusion_torch.models.distributions import NumNodesDistribution
    from bio_diffusion_torch.train.sampling import batch_pad

    dist = NumNodesDistribution(QM9_WITH_H["n_nodes"])
    sizes = dist.sample(b, np.random.default_rng(seed))
    return sizes, batch_pad(sizes, dist)


def build_probe(kernel: str = "fwd") -> ctypes.CDLL:
    """The forward kernel's or the backward's source built with its phase marks."""
    from bio_diffusion_torch.ops import build

    path, _ = build.compile_source(build.SOURCE_DIR / f"{SOURCES[kernel][0]}.cu", defines=("PHASE_PROBE",))
    lib = ctypes.CDLL(str(path))
    lib.phases_read.argtypes, lib.phases_read.restype = [ctypes.POINTER(ctypes.c_ulonglong)], ctypes.c_int
    lib.phases_reset.argtypes, lib.phases_reset.restype = [], ctypes.c_int
    return lib


def measure(torch, b: int, n: int, dtype, seed: int = 0, kernel: str = "fwd",
            sizes: Optional[Sequence[int]] = None) -> Tuple[Dict[str, float], Tuple[int, int]]:
    """Phase name -> SM cycles per block of one probed launch, and the rows
    it computed and covered (the forward's counters; zero for the backward).
    ``sizes``: the molecules' atoms, the rest of the ``n`` nodes padding."""
    from bio_diffusion_torch.cli.bench_passes import layer_inputs
    from bio_diffusion_torch.ops import build
    from bio_diffusion_torch.ops import message_layer as ml

    lib = build_probe(kernel)
    args = layer_inputs(torch, b, n, dtype, seed)
    if sizes is not None:
        mask = (torch.arange(n, device="cuda")[None, :] < torch.as_tensor(sizes, device="cuda")[:, None]).to(dtype)
        em = (mask[:, :, None] * mask[:, None, :]).reshape(b, n * n, 1)
        args = (args[0] * mask[..., None], args[1] * mask[..., None], args[2] * em) + args[3:]
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
    if counters[len(names) - 1] == 0 or any(counters[len(names):ROW_SLOTS[0]]):
        raise RuntimeError(f"the kernel's phase marks do not match the {len(names)} named phases")
    rows = (counters[ROW_SLOTS[0]], counters[ROW_SLOTS[1]])
    return {name: counters[i] / (b * n) for i, name in enumerate(names)}, rows


def main(argv=None) -> Dict[str, object]:
    import torch

    argv = list(sys.argv[1:] if argv is None else argv)
    opts = {"--kernel": "fwd", "--b": None, "--n": None, "--precision": None, "--qm9-sizes": None}
    while argv:
        flag = argv.pop(0)
        if flag not in opts or not argv:
            print(__doc__.strip())
            raise SystemExit(0 if flag == "--help" else f"unknown argument {flag!r}")
        opts[flag] = argv.pop(0)
    kernel = opts["--kernel"]
    if kernel not in SOURCES:
        raise SystemExit(f"--kernel is fwd or bwd, not {kernel!r}")
    sizes = None
    if opts["--qm9-sizes"] is not None:
        if opts["--n"] is not None:
            raise SystemExit("--qm9-sizes sets N: give no --n")
        sizes, pad = qm9_batch(int(opts["--b"] or DEFAULTS[kernel][0]), int(opts["--qm9-sizes"]))
        opts["--n"] = str(pad)
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
    phases, rows = measure(torch, b, n, dtypes[opts["--precision"]], kernel=kernel, sizes=sizes)
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
    if kernel == "fwd":
        expected = expected_rows(sizes if sizes is not None else [n] * b, n)
        print(f"#   rows computed / covered: {rows[0]} / {rows[1]} = {rows[0] / rows[1]:.4f} "
              f"(expected {expected[0]} / {expected[1]} = {expected[0] / expected[1]:.4f})")
        result.update(rows_computed=rows[0], rows_covered=rows[1], rows_expected=list(expected),
                      sizes=None if sizes is None else [int(x) for x in sizes])
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
