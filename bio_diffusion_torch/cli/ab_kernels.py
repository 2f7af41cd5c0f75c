"""Time the message-layer kernels (B1 forward, B2 backward), the flat-edge
chain kernel (B3) and the pass probe (B4) of this checkout against another
version of their sources, in one process on one CUDA card.

Usage:
  python -m bio_diffusion_torch.cli.ab_kernels --other DIR [--reps 20]

DIR holds the other ``message_layer.cu``, ``message_layer_bwd.cu``,
``gcp2_chain.cu``, ``elementwise_passes.cu`` and their header, for instance a
parent commit's, unpacked
with ``git archive <commit> bio_diffusion_torch/csrc bio_diffusion_torch/ops
| tar -x -C build/parent`` (DIR is then
``build/parent/bio_diffusion_torch/csrc``).  Both versions are built with
the same nvcc flags, and the other is launched through its own tree's ops
wrappers where DIR's sibling ``ops/`` holds them (their C interface may
differ from this checkout's), else through this checkout's
(``build.library_override`` either way).  On the same inputs (full QM9
width, weights and inputs drawn from a seed) each pair's outputs are
compared (max difference over max|this|) and timed in turns, other, this,
this, other (CUDA events, best of two each): B1 in bf16 at B=8/N=19,
B=250/N=19, B=64/N=29 and B=16/N=64 and in float32 at B=64/N=29; B2 at
B=64/N=29 in both dtypes and at GEOM width (Se=16, Ve=8) at B=16/N=96 in
float32, walked in chunks of 4 molecules, all 21 outputs, each also marked
bit-identical or not, with each of its kernels' device times per launch
(``torch.profiler``, in the same turns; an older tree's ``reduce_kernel``
too); B3 at E=53,824 and 90,250 in both dtypes; B4, each of its nine ops
at k = 1, 8 and 104 passes over a seeded [90250, 256] float32 array and over
a ragged, misaligned view (77,077 elements from the second of a fresh
tensor).  Prints one line per pair
and, last, one JSON object.  Without a CUDA device it exits with an error.
"""

from __future__ import annotations

import contextlib
import ctypes
import importlib.util
import json
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict

from bio_diffusion_torch.cli.bench_passes import QM9, layer_inputs
from bio_diffusion_torch.cli.profile_train import KERNEL_GROUPS

GEOM = dict(QM9, se=16, ve=8)
B1_SHAPES = (("bfloat16", 8, 19), ("bfloat16", 250, 19), ("bfloat16", 64, 29), ("bfloat16", 16, 64),
             ("float32", 64, 29))
# (dtype, B, N, widths, molecules a chunk of the backward's walk or None)
B2_SHAPES = (("float32", 64, 29, QM9, None), ("bfloat16", 64, 29, QM9, None), ("float32", 16, 96, GEOM, 4))
B3_SHAPES = (("bfloat16", 53824), ("bfloat16", 90250), ("float32", 53824), ("float32", 90250))
NAMES = ("message_layer", "message_layer_bwd", "gcp2_chain", "elementwise_passes")
PASS_KS = (1, 8, 104)
PASS_SHAPE = (90250, 256)
PASS_RAGGED = 1001 * 77
# the backward's kernels by name, with an older tree's separate reduction of
# the weight-grad partials
BWD_KERNELS = KERNEL_GROUPS["message_layer_bwd"] + ("reduce_kernel",)


def build_other(src_dir: Path) -> Dict[str, ctypes.CDLL]:
    """Compile DIR's sources (one nvcc each, started together)."""
    from bio_diffusion_torch.ops import build

    with ThreadPoolExecutor(len(NAMES)) as pool:
        built = pool.map(lambda name: build.compile_source(src_dir / f"{name}.cu")[0], NAMES)
        return {name: ctypes.CDLL(str(path)) for name, path in zip(NAMES, built)}


def other_wrappers(src_dir: Path) -> Dict[str, object]:
    """The other tree's ops modules (``message_layer``, ``gcp2_chain``,
    ``passes``) from DIR's sibling ``ops/``, each loaded under a name of its
    own; this checkout's where the other tree has none."""
    from bio_diffusion_torch.ops import gcp2_chain, message_layer, passes

    out = {}
    for mod in (message_layer, gcp2_chain, passes):
        name = mod.__name__.rsplit(".", 1)[1]
        path = src_dir.parent / "ops" / f"{name}.py"
        if path.is_file():
            spec = importlib.util.spec_from_file_location(f"ab_other_{name}", path)
            other = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(other)
            out[name] = other
        else:
            out[name] = mod
    return out


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


def compare(torch, lib, name: str, run, reps: int, sub_kernels=None) -> Dict[str, object]:
    """Outputs of both versions (``run(this_or_other)`` returns a list of
    ``(name, tensor)``; the argument says which tree's wrappers to call:
    each one's difference over max|this| and whether it is bit-identical)
    and their times in turns (other, this, this, other); given
    ``sub_kernels`` (kernel names) also the device ms per launch of each,
    best of the two turns."""
    from bio_diffusion_torch.cli.profile_train import group_kernel_ms
    from bio_diffusion_torch.ops import build

    def version(who):
        return build.library_override(name, lib) if who == "other" else contextlib.nullcontext()

    with version("other"):
        theirs = run("other")
    ours = run("this")
    torch.cuda.synchronize()
    diffs, identical = {}, []
    for (what, a), (_, b) in zip(theirs, ours):
        ref = b.float().abs().max().item()
        err = (a.float() - b.float()).abs().max().item()
        diffs[what] = err / ref if ref > 0 else err
        if torch.equal(a, b):
            identical.append(what)
    times = {"other": [], "this": []}
    subs = {"other": [], "this": []}
    for who in ("other", "this", "this", "other"):
        with version(who):
            times[who].append(time_ms(torch, lambda: run(who), reps))
            if sub_kernels:
                subs[who].append(group_kernel_ms(torch, lambda: run(who), 5, name, sub_kernels))
    out = {"this_ms": min(times["this"]), "other_ms": min(times["other"]),
           "max_rel_diff": max(diffs.values()), "rel_diff": diffs, "bit_identical": identical,
           "all_bit_identical": len(identical) == len(diffs), "runs": times}
    if sub_kernels:
        out["sub_kernels_ms"] = {who: {k: min(r[k] for r in runs) for k in runs[0]}
                                 for who, runs in subs.items()}
    return out


def named(outputs) -> list:
    return [(str(k), t) for k, t in enumerate(outputs)]


def main(argv=None) -> Dict[str, object]:
    import torch

    from bio_diffusion_torch.ops import gcp2_chain as gc
    from bio_diffusion_torch.ops import message_layer as ml
    from bio_diffusion_torch.ops import passes

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
    wrappers = other_wrappers(Path(opts["--other"]))
    mods = {"this": {"message_layer": ml, "gcp2_chain": gc, "passes": passes}, "other": wrappers}
    dtypes = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    print(f"# {torch.cuda.get_device_name(0)}; this checkout's kernels (this) against {opts['--other']} "
          f"(other, through {'its own' if wrappers['message_layer'] is not ml else 'this checkout'}'s wrappers), "
          f"in turns, best of two x {reps} launches (CUDA events)")
    results = {}
    for dt, b, n in B1_SHAPES:
        s, v, epack, g1, chain = layer_inputs(torch, b, n, dtypes[dt])
        r = compare(torch, other["message_layer"], "message_layer",
                    lambda who: named(mods[who]["message_layer"].fused_message_layer(s, v, epack, g1, chain,
                                                                                      ve_dim=QM9["ve"])), reps)
        results[f"message_layer {dt} B={b} N={n}"] = r
    for dt, b, n, widths, chunk in B2_SHAPES:
        s, v, epack, g1, chain = layer_inputs(torch, b, n, dtypes[dt], widths=widths)
        gen = torch.Generator(device="cuda").manual_seed(1)
        ct = (torch.randn(s.shape, generator=gen, device="cuda").to(s.dtype),
              torch.randn(v.shape, generator=gen, device="cuda").to(v.dtype))

        def run(who):
            mod = mods[who]["message_layer"]
            return ml.bwd_outputs(mod._message_layer_bwd_cuda(s, v, epack, g1, chain, ct, widths["ve"],
                                                              chunk_molecules=chunk))

        r = compare(torch, other["message_layer_bwd"], "message_layer_bwd", run, max(2, reps // 4),
                    sub_kernels=BWD_KERNELS)
        where = "GEOM " if widths is GEOM else ""
        results[f"message_layer_bwd {where}{dt} B={b} N={n}" + (f" chunks of {chunk}" if chunk else "")] = r
    for dt, e in B3_SHAPES:
        args = chain_inputs(torch, e, dtypes[dt])
        results[f"gcp2_chain {dt} E={e}"] = compare(
            torch, other["gcp2_chain"], "gcp2_chain", lambda who: named(mods[who]["gcp2_chain"].fused_gcp2_chain(*args)),
            reps)
    gen = torch.Generator(device="cuda").manual_seed(0)
    inputs = {"": torch.randn(PASS_SHAPE, generator=gen, device="cuda"),
              " ragged misaligned": torch.randn(PASS_RAGGED + 1, generator=gen, device="cuda")[1:]}
    for op in passes.OPS:
        for where, x in inputs.items():
            for k in PASS_KS:
                results[f"elementwise_passes {op} k={k}{where}"] = compare(
                    torch, other["elementwise_passes"], "elementwise_passes",
                    lambda who: [("out", mods[who]["passes"].repeat_op(x, op, k))], reps)
    for what, r in results.items():
        same = "all" if r["all_bit_identical"] else f"{len(r['bit_identical'])} of {len(r['rel_diff'])}"
        print(f"{what:>40}: this {r['this_ms']:.4f} ms, other {r['other_ms']:.4f} ms "
              f"(this/other {r['this_ms'] / r['other_ms']:.3f}), max rel diff {r['max_rel_diff']:.3g}, "
              f"bit-identical: {same}")
        for who, subs in r.get("sub_kernels_ms", {}).items():
            print(f"{'':>42}{who}: " + ", ".join(f"{k} {ms:.4f} ms" for k, ms in subs.items()))
        if not r["all_bit_identical"]:
            print(f"{'':>42}differences: " + ", ".join(f"{k} {d:.3g}" for k, d in r["rel_diff"].items()
                                                       if k not in r["bit_identical"]))
    out = {"device": torch.cuda.get_device_name(0), "other": opts["--other"], "pairs": results}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
