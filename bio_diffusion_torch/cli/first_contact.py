"""Day-one validation of a released reference checkpoint on the card.

Counterpart of ``scripts/first_contact.py``: the one command that takes a
reference checkpoint (e.g. the Zenodo QM9 EMA ``.ckpt``, record 13375913)
from import through sampling to the paper's targets, with no code written
that day:

1. import: strict, through ``cli/common.py::load_model`` (every parameter of
   the model must come from the file, nothing else may be in it);
2. sampling (``sample_molecules`` on ``SegmentedSampler``) and scoring
   (``analyze_samples`` with ``chem/rdkit_bridge``'s metrics where RDKit
   imports): atom and molecule stability and validity against ``TARGETS``;
3. with ``--data-dir``, the test NLL over up to 10 batches of the test split
   (``make_eval_step``), informational.

Usage:
  python -m bio_diffusion_torch.cli.first_contact --ckpt /path/to/QM9-EMA.ckpt \\
      [--smiles /path/to/train_smiles.npy]    # enables novelty
      [--data-dir /path/to/qm9]               # enables the test-NLL check
      [--num-samples 250] [--num-timesteps 1000] [--batch 250]
      [--out first_contact.json] [--device cuda|cpu] [key=value overrides ...]

Exit code 0 iff every available check passes; the JSON report carries a
per-metric verdict either way (a metric that could not be computed, e.g.
validity without RDKit, has ``ok: null`` with its target and tolerance).

Targets (GCDM paper, arXiv 2302.04313, QM9 unconditional; BASELINE.md
"Targets for the TPU rebuild"): atom stability 98.7%, molecule stability
89%, validity 94.5-95%.  Tolerance = 1 percentage point (the BASELINE
north-star band) widened by 3x the binomial standard error at the requested
sample count, so a 250-molecule smoke run is judged fairly while a
10,000-molecule paper-protocol run is tight.  ``--device`` defaults to
``cuda`` (there is no fallback).  Prints the seconds of each phase.
"""

from __future__ import annotations

import argparse
import json
import math
import time

import numpy as np

from bio_diffusion_torch.train.sampling import SegmentedSampler, analyze_samples, sample_molecules

# paper-protocol targets: metric -> target fraction
TARGETS = {
    "atm_stable": 0.987,
    "mol_stable": 0.890,
    "validity": 0.949,
}
BAND = 0.01  # BASELINE.md: "within 1% of the paper values"


def tolerance(target: float, n: int) -> float:
    """1pt band + 3 binomial standard errors at sample size n."""
    return BAND + 3.0 * math.sqrt(target * (1.0 - target) / max(n, 1))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--ckpt", required=True,
                    help="reference Lightning .ckpt (e.g. the Zenodo QM9 EMA checkpoint)")
    ap.add_argument("--smiles", default=None, help="train-set SMILES .npy for novelty (optional)")
    ap.add_argument("--data-dir", default=None, help="processed QM9 directory for the test-NLL pass (optional)")
    ap.add_argument("--num-samples", type=int, default=250)
    ap.add_argument("--num-timesteps", type=int, default=1000)
    ap.add_argument("--batch", type=int, default=250)
    ap.add_argument("--remove-h", action="store_true", help="evaluate the no-hydrogen QM9 variant")
    ap.add_argument("--out", default="first_contact.json")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("overrides", nargs="*", help="extra key=value config overrides (hydra style)")
    args = ap.parse_args(argv)

    import torch

    from bio_diffusion_torch.chem.rdkit_bridge import build_molecular_metrics
    from bio_diffusion_torch.cli.common import (
        device_of,
        load_model,
        nodes_distribution_for,
        parse_cli,
        precision_of,
        with_precision,
    )
    from bio_diffusion_torch.config.build import build_experiment, get_dataset_info_for

    report = {"ckpt": args.ckpt, "num_samples": args.num_samples,
              "num_timesteps": args.num_timesteps, "checks": {}, "pass": None}
    seconds = {}

    def write_report():
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)

    overrides = [f"datamodule.dataloader_cfg.remove_h={str(args.remove_h).lower()}"]
    if args.data_dir:
        overrides.append(f"datamodule.dataloader_cfg.data_dir={args.data_dir}")
    if args.smiles:
        overrides.append(f"datamodule.dataloader_cfg.smiles_filepath={args.smiles}")
    overrides += args.overrides
    cfg, _ = parse_cli(overrides + [f"device={args.device}"], "mol_gen_eval")
    exp = build_experiment(with_precision(cfg, precision_of(cfg)))
    device = device_of(cfg)
    dataset_info = get_dataset_info_for(exp)
    nodes_dist = nodes_distribution_for(exp)

    # 1. checkpoint import: strict, every model parameter must come from the file
    t0 = time.perf_counter()
    try:
        evd = load_model(exp, args.ckpt, device)
        n_leaves = sum(1 for _ in evd.parameters())
        report["checks"]["import"] = {"ok": True, "leaves": n_leaves}
        seconds["import"] = time.perf_counter() - t0
        print(f"[1/3] checkpoint import OK ({n_leaves} param leaves) {seconds['import']:.3f} s")
    except Exception as e:  # noqa: BLE001 - report, don't crash
        report["checks"]["import"] = {"ok": False, "error": str(e)}
        report["pass"] = False
        write_report()
        print(json.dumps({"pass": False, "failed": "import", "error": str(e)}))
        return 1

    # 2. sample + stability/validity against the paper's targets
    t0 = time.perf_counter()
    xh, node_mask, _ = sample_molecules(
        SegmentedSampler(evd), torch.Generator(device=device).manual_seed(exp.seed), args.num_samples, nodes_dist,
        np.random.default_rng(exp.seed), batch_size=args.batch, num_timesteps=args.num_timesteps)
    metrics = analyze_samples(xh, node_mask, dataset_info, include_charges=exp.dataloader_cfg.include_charges,
                              molecular_metrics=build_molecular_metrics(dataset_info, args.smiles))
    all_ok = True
    for name, target in TARGETS.items():
        tol = tolerance(target, args.num_samples)
        if name not in metrics:
            report["checks"][name] = {"ok": None, "note": "not computed (rdkit missing?)",
                                      "target": target, "tolerance": round(tol, 4)}
            continue
        ok = metrics[name] >= target - tol
        all_ok &= ok
        report["checks"][name] = {"ok": bool(ok), "value": round(float(metrics[name]), 4),
                                  "target": target, "tolerance": round(tol, 4)}
        print(f"[2/3] {name}: {metrics[name]:.4f} vs target {target} (-{tol:.3f} tolerated) -> "
              f"{'PASS' if ok else 'FAIL'}")
    if "novelty" in metrics:
        report["checks"]["novelty"] = {"ok": None, "value": round(float(metrics["novelty"]), 4),
                                       "note": "informational"}
    report["metrics"] = {k: round(float(v), 5) for k, v in metrics.items()}
    seconds["sampling"] = time.perf_counter() - t0
    print(f"[2/3] sampling and scoring of {args.num_samples} molecules at T={args.num_timesteps}: "
          f"{seconds['sampling']:.3f} s")

    # 3. test NLL (informational; protocol of the reference's
    #    src/mol_gen_eval.py:172-186, one pass of up to 10 batches here)
    if args.data_dir:
        t0 = time.perf_counter()
        try:
            from bio_diffusion_torch.config.build import build_datasets
            from bio_diffusion_torch.data.batch import iterate_dense_batches
            from bio_diffusion_torch.train.step import make_eval_step

            datasets = build_datasets(exp)
            eval_step = make_eval_step(evd, exp.diffusion_cfg, exp.dataloader_cfg, nodes_dist.log_prob_table)
            nlls, rng = [], np.random.default_rng(0)
            generator = torch.Generator(device=device).manual_seed(0)
            for i, b in enumerate(iterate_dense_batches(datasets["test"], batch_size=args.batch, rng=rng)):
                nlls.append(float(eval_step(b.to(device), generator)["loss"]))
                if i >= 9:
                    break
            report["checks"]["test_nll"] = {"ok": None, "value": round(float(np.mean(nlls)), 4),
                                            "note": "informational — compare to the paper"}
            seconds["test_nll"] = time.perf_counter() - t0
            print(f"[3/3] test NLL ({len(nlls)} batches): {np.mean(nlls):.4f} {seconds['test_nll']:.3f} s")
        except Exception as e:  # noqa: BLE001
            report["checks"]["test_nll"] = {"ok": None, "error": str(e)}
    else:
        print("[3/3] test NLL skipped (no --data-dir)")

    report["pass"] = bool(all_ok)
    write_report()
    print(json.dumps({"pass": report["pass"], "checks": {k: v.get("ok") for k, v in report["checks"].items()},
                      "seconds": seconds}))
    return 0 if all_ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
