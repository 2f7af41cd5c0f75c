"""Shape sweep: per-molecule sampling cost on the card across (batch, N).

Counterpart of ``scripts/bench_shape_sweep.py``.  How does the steady-state
denoiser-evaluation rate of the sampler depend on the batch size and the
padded molecule size?  It runs the port's ``SegmentedSampler`` at the
shipped QM9 width (``experiment=qm9_mol_gen_ddpm``: 9 layers, S=256, V=32,
Se=64, Ve=16, T=1000) with the bf16 network body (the JAX script's
``compute_dtype="bfloat16"``), weights drawn from seed 0, on full masks of
each (B, N): one warm-up run, then one timed run of ``--steps`` reverse
steps and the decode, the card synchronized before and after it.  Each run
launches the message-layer kernel 9 times a denoiser call (``--steps`` + 1
calls); the launches of each timed run are read from
``ops/message_layer.launch_counts`` around it.

Usage:
  python -m bio_diffusion_torch.cli.bench_shape_sweep [--steps 100] [--batches 32 64 ...]
      [--nodes 16 19 ...] [--cross] [--device cuda|cpu] [key=value config overrides ...]

``--cross`` sweeps the batches at nodes[1] and the nodes at batches[2] (a
cross, not the full grid).  Prints one line per run to stderr, and one JSON
line: ``{"rows": [{batch, nodes, evals_per_s, us_per_mol_step, seconds,
launches}, ...], "n_exponent": fitted d(log cost)/d(log N) at the largest
batch >= 125 with more than one N, "fit_batch", "steps"}``.  ``--device``
defaults to ``cuda`` (there is no fallback); the overrides (e.g. a tiny
width for a CPU run) go to ``configs/train.yaml``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def build_sampler(device, overrides=()):
    """The shipped QM9 model in bf16 with weights from seed 0, on ``device``,
    and its ``SegmentedSampler``."""
    from bio_diffusion_torch.config.build import build_evd, build_experiment
    from bio_diffusion_torch.config.loader import default_config_dir, load_config
    from bio_diffusion_torch.train.sampling import SegmentedSampler
    from bio_diffusion_torch.train.torch_import import init_random_weights

    cfg = load_config(default_config_dir(), "train",
                      ["experiment=qm9_mol_gen_ddpm", "trainer.precision=bf16", *overrides])
    evd = build_evd(build_experiment(cfg))
    init_random_weights(evd, 0)
    return SegmentedSampler(evd.to(device).eval())


def sweep_grid(batches, nodes, cross: bool):
    if cross:
        n_pin = nodes[min(1, len(nodes) - 1)]
        b_pin = batches[min(2, len(batches) - 1)]
        return [(b, n_pin) for b in batches] + [(b_pin, n) for n in nodes if n != n_pin]
    return [(b, n) for n in nodes for b in batches]


def fit_exponent(rows):
    """cost ~ N^k at the largest batch >= 125 that has more than one N (else
    the largest such batch) -> (k or None, that batch)."""
    covered = {b for b in (r["batch"] for r in rows) if len({r["nodes"] for r in rows if r["batch"] == b}) > 1}
    fit_b = max((b for b in covered if b >= 125), default=max(covered, default=None))
    pts = [(r["nodes"], r["us_per_mol_step"]) for r in rows if r["batch"] == fit_b]
    k = float(np.polyfit(np.log([p[0] for p in pts]), np.log([p[1] for p in pts]), 1)[0]) if len(pts) > 1 else None
    return k, fit_b


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batches", type=int, nargs="*", default=[32, 64, 125, 250, 500])
    ap.add_argument("--nodes", type=int, nargs="*", default=[16, 19, 22, 25, 29])
    ap.add_argument("--cross", action="store_true",
                    help="sweep batches at nodes[1] and nodes at batches[2] (a cross, not the full grid)")
    ap.add_argument("--device", default="cuda")
    argv = list(sys.argv[1:] if argv is None else argv)
    overrides = [a for a in argv if "=" in a and not a.startswith("-")]  # key=value config overrides
    args = ap.parse_args([a for a in argv if a not in overrides])

    import torch

    from bio_diffusion_torch.ops import message_layer as ml

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda but no CUDA device is available (there is no CPU fallback)")
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    sampler = build_sampler(device, overrides)
    print(f"# device={device} ({torch.cuda.get_device_name(device) if device.type == 'cuda' else 'cpu'}) "
          f"bf16 body, steps={args.steps}", file=sys.stderr)

    rows = []
    for batch, nodes in sweep_grid(args.batches, args.nodes, args.cross):
        mask = np.ones((batch, nodes), dtype=np.float32)
        sampler.run(mask, torch.Generator(device=device).manual_seed(1), num_timesteps=args.steps)  # warm-up
        sync()
        before, t0 = ml.launch_counts["message_layer"], time.perf_counter()
        sampler.run(mask, torch.Generator(device=device).manual_seed(2), num_timesteps=args.steps)
        sync()
        dt = time.perf_counter() - t0
        rate = batch * args.steps / dt
        rows.append({"batch": batch, "nodes": nodes, "evals_per_s": round(rate, 1),
                     "us_per_mol_step": round(1e6 * dt / (batch * args.steps), 3), "seconds": dt,
                     "launches": ml.launch_counts["message_layer"] - before})
        print(f"# B={batch:4d} N={nodes:3d}  {rate:10.1f} evals/s  {rows[-1]['us_per_mol_step']:7.3f} us/mol-step  "
              f"{rows[-1]['launches']} launches", file=sys.stderr)

    k, fit_b = fit_exponent(rows)
    result = {"rows": rows, "n_exponent": round(k, 2) if k is not None else None, "fit_batch": fit_b,
              "steps": args.steps}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
