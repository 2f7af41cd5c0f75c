"""Time the forward message-layer kernel (B1) and the flat-edge chain kernel
(B3) of this checkout against another version of their sources, in one
process on one CUDA card.

Usage:
  python -m bio_diffusion_torch.cli.ab_kernels --other DIR [--reps 20]

DIR holds the other ``message_layer.cu``, ``gcp2_chain.cu`` and their header,
for instance a parent commit's, unpacked with
``git archive <commit> bio_diffusion_torch/csrc | tar -x -C build/parent``
(DIR is then ``build/parent/bio_diffusion_torch/csrc``).  Both versions are
built with the same nvcc flags, and the other is launched through the ops
modules' own wrappers (``build.library_override``).  On the same inputs (full QM9 width, weights
and inputs drawn from a seed) each pair's outputs are compared (max
difference over max|this|) and timed in turns, other, this, this, other (CUDA
events, best of two each): B1 in bf16 at B=8/N=19, B=250/N=19, B=64/N=29 and
B=16/N=64 and in float32 at B=64/N=29; B3 at E=53,824 and 90,250 in both
dtypes.  Prints one line per pair and, last, one JSON object.  Without a
CUDA device it exits with an error.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict

from bio_diffusion_torch.cli.bench_passes import QM9, layer_inputs

B1_SHAPES = (("bfloat16", 8, 19), ("bfloat16", 250, 19), ("bfloat16", 64, 29), ("bfloat16", 16, 64),
             ("float32", 64, 29))
B3_SHAPES = (("bfloat16", 53824), ("bfloat16", 90250), ("float32", 53824), ("float32", 90250))
NAMES = ("message_layer", "gcp2_chain")


def build_other(src_dir: Path) -> Dict[str, ctypes.CDLL]:
    """Compile DIR's two sources (one nvcc each, started together)."""
    from bio_diffusion_torch.ops import build

    with ThreadPoolExecutor(len(NAMES)) as pool:
        built = pool.map(lambda name: build.compile_source(src_dir / f"{name}.cu")[0], NAMES)
        return {name: ctypes.CDLL(str(path)) for name, path in zip(NAMES, built)}


def chain_inputs(torch, e: int, dtype, seed: int = 0) -> list:
    """Flat rows s, v, frames_t and the stacked chain weights of one
    full-width layer, drawn from ``seed``, on the card."""
    from bio_diffusion_torch.config.schema import LayerConfig, ModuleConfig
    from bio_diffusion_torch.models.gcpnet import GCPMessagePassing, stack_chain_weights
    from bio_diffusion_torch.train.torch_import import init_random_weights

    mp = GCPMessagePassing((QM9["s_dim"], QM9["v_dim"]), (QM9["se"], QM9["ve"]), ModuleConfig(), LayerConfig())
    init_random_weights(mp, seed)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows = [torch.randn(e, QM9["s_dim"], generator=gen, device="cuda"),
            torch.randn(e, 3 * QM9["v_dim"], generator=gen, device="cuda"),
            torch.rand(e, 9, generator=gen, device="cuda") * 2 - 1]
    with torch.no_grad():
        weights = [w.contiguous() for w in stack_chain_weights(mp.to("cuda"), dtype)]
    return [r.to(dtype) for r in rows] + weights


def time_ms(torch, fn, reps: int) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare(torch, lib, name: str, run, reps: int) -> Dict[str, float]:
    """Outputs of both versions and their times in turns (other, this, this, other)."""
    from bio_diffusion_torch.ops import build

    with build.library_override(name, lib):
        theirs = run()
    ours = run()
    torch.cuda.synchronize()
    diff = max((a.float() - b.float()).abs().max().item() / b.float().abs().max().item()
               for a, b in zip(theirs, ours))
    times = {"other": [], "this": []}
    for who in ("other", "this", "this", "other"):
        with build.library_override(name, lib) if who == "other" else contextlib.nullcontext():
            times[who].append(time_ms(torch, run, reps))
    return {"this_ms": min(times["this"]), "other_ms": min(times["other"]), "max_rel_diff": diff,
            "runs": times}


def main(argv=None) -> Dict[str, object]:
    import torch

    from bio_diffusion_torch.ops import gcp2_chain as gc
    from bio_diffusion_torch.ops import message_layer as ml

    argv = list(sys.argv[1:] if argv is None else argv)
    opts = {"--other": None, "--reps": "20"}
    while argv:
        flag = argv.pop(0)
        if flag not in opts or not argv:
            print(__doc__.strip())
            raise SystemExit(0 if flag == "--help" else f"unknown argument {flag!r}")
        opts[flag] = argv.pop(0)
    if opts["--other"] is None:
        raise SystemExit("ab_kernels needs --other DIR")
    if not torch.cuda.is_available():
        raise SystemExit("ab_kernels needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    reps = int(opts["--reps"])
    other = build_other(Path(opts["--other"]))
    dtypes = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    print(f"# {torch.cuda.get_device_name(0)}; this checkout's kernels (this) against {opts['--other']} "
          f"(other), in turns, best of two x {reps} launches (CUDA events)")
    results = {}
    for dt, b, n in B1_SHAPES:
        s, v, epack, g1, chain = layer_inputs(torch, b, n, dtypes[dt])
        r = compare(torch, other["message_layer"], "message_layer",
                    lambda: ml.fused_message_layer(s, v, epack, g1, chain, ve_dim=QM9["ve"]), reps)
        results[f"message_layer {dt} B={b} N={n}"] = r
    for dt, e in B3_SHAPES:
        args = chain_inputs(torch, e, dtypes[dt])
        results[f"gcp2_chain {dt} E={e}"] = compare(torch, other["gcp2_chain"], "gcp2_chain",
                                                   lambda: gc.fused_gcp2_chain(*args), reps)
    for what, r in results.items():
        print(f"{what:>36}: this {r['this_ms']:.4f} ms, other {r['other_ms']:.4f} ms "
              f"(this/other {r['this_ms'] / r['other_ms']:.3f}), max rel diff {r['max_rel_diff']:.3g}")
    out = {"device": torch.cuda.get_device_name(0), "other": opts["--other"], "pairs": results}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
