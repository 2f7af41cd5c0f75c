"""Aggregate inference results across runs: means + confidence intervals.

The PyTorch package's copy of ``bio_diffusion_tpu/analysis/inference_analysis.py``
(host side: numpy, pandas, scipy, matplotlib; nothing of the JAX package).

Counterpart of the reference's src/analysis/inference_analysis.py: t-interval
aggregation of repeated sampling-evaluation runs, and the PoseBusters-CSV
validity conjunction.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Dict, List, Sequence, Tuple

import numpy as np

# the 11 PoseBusters checks whose conjunction defines PB-validity
# (reference inference_analysis.py:110-127)
POSEBUSTERS_COLUMNS = [
    "mol_pred_loaded",
    "sanitization",
    "inchi_convertible",
    "all_atoms_connected",
    "bond_lengths",
    "bond_angles",
    "internal_steric_clash",
    "aromatic_ring_flatness",
    "double_bond_flatness",
    "internal_energy",
    "passes_valence_checks",
    "passes_kekulization",
]


def calculate_mean_and_conf_int(data: Sequence[float], alpha: float = 0.95) -> Tuple[float, Tuple[float, float]]:
    """Sample mean + t-distribution confidence interval (reference :27-41)."""
    from scipy import stats

    data = np.asarray(data, dtype=np.float64)
    mean = float(data.mean())
    if len(data) < 2:
        return mean, (mean, mean)
    interval = stats.t.interval(
        alpha, len(data) - 1, loc=mean, scale=stats.sem(data)
    )
    return mean, (float(interval[0]), float(interval[1]))


def aggregate_eval_results(result_files: Sequence[str]) -> Dict[str, Dict[str, float]]:
    """Aggregate eval_results.json files from repeated runs into
    mean +/- CI per metric."""
    runs: List[Dict] = []
    for f in result_files:
        with open(f) as fh:
            runs.append(json.load(fh))
    metrics = sorted({k for r in runs for k in r if isinstance(r[k], (int, float))})
    out = {}
    for m in metrics:
        vals = [r[m] for r in runs if m in r]
        mean, (lo, hi) = calculate_mean_and_conf_int(vals)
        out[m] = {"mean": mean, "ci_low": lo, "ci_high": hi, "n": len(vals)}
    return out


def posebusters_validity(bust_csv_path: str) -> Dict[str, float]:
    """Fraction of molecules passing ALL PoseBusters checks plus per-check rates."""
    import pandas as pd

    df = pd.read_csv(bust_csv_path)
    cols = [c for c in POSEBUSTERS_COLUMNS if c in df.columns]
    per_check = {c: float(df[c].mean()) for c in cols}
    if cols:
        per_check["pb_valid"] = float(df[cols].all(axis=1).mean())
    return per_check


def main(argv=None):
    import sys

    args = list(sys.argv[1:] if argv is None else argv)
    if not args:
        print("usage: inference_analysis <glob-of-eval_results.json> [bust.csv]")
        return
    files = sorted(glob.glob(args[0]))
    agg = aggregate_eval_results(files)
    print(json.dumps(agg, indent=2))
    if len(args) > 1 and os.path.exists(args[1]):
        print(json.dumps(posebusters_validity(args[1]), indent=2))


if __name__ == "__main__":
    main()
