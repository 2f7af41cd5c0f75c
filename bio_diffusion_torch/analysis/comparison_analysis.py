"""Method-comparison plots: PoseBusters box plots + optimization bar charts.

The PyTorch package's copy of ``bio_diffusion_tpu/analysis/comparison_analysis.py``
(host side: numpy, pandas, scipy, matplotlib; nothing of the JAX package).

Counterparts of the reference's src/analysis/bust_analysis.py (seaborn box
plot comparing two methods' bust CSVs) and optimization_analysis.py (bar
plots of stability/MAE across guided-optimization step counts, against the
paper's published GCDM-Opt values).
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence

import numpy as np

# published GCDM-Opt results (reference optimization_analysis.py:33-72);
# kept as the comparison baseline for our optimization runs
PAPER_INITIAL_10_STEP_MOL_STABILITY = 0.617
PAPER_OPT_100_STEPS = {
    "alpha": {"mol_stable": 0.862, "mae": 3.29},
    "gap": {"mol_stable": 0.890, "mae": 0.93},
    "homo": {"mol_stable": 0.916, "mae": 0.43},
    "lumo": {"mol_stable": 0.870, "mae": 0.86},
    "mu": {"mol_stable": 0.899, "mae": 1.08},
    "Cv": {"mol_stable": 0.876, "mae": 1.81},
}
PAPER_OPT_250_STEPS_MOL_STABILITY = {
    "alpha": 0.866, "gap": 0.897, "homo": 0.907,
    "lumo": 0.886, "mu": 0.895, "Cv": 0.876,
}


def compare_bust_csvs(csv_a: str, csv_b: str, labels=("method_a", "method_b"),
                      out_png: Optional[str] = None) -> Dict[str, Dict[str, float]]:
    """Per-check pass rates for two methods (+ optional bar plot)."""
    from bio_diffusion_torch.analysis.inference_analysis import posebusters_validity

    a = posebusters_validity(csv_a)
    b = posebusters_validity(csv_b)
    result = {labels[0]: a, labels[1]: b}

    if out_png:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        checks = sorted(set(a) | set(b))
        x = np.arange(len(checks))
        fig, ax = plt.subplots(figsize=(12, 4))
        ax.bar(x - 0.2, [a.get(c, 0) for c in checks], 0.4, label=labels[0])
        ax.bar(x + 0.2, [b.get(c, 0) for c in checks], 0.4, label=labels[1])
        ax.set_xticks(x)
        ax.set_xticklabels(checks, rotation=45, ha="right")
        ax.set_ylabel("pass rate")
        ax.legend()
        fig.tight_layout()
        fig.savefig(out_png, dpi=120)
        plt.close(fig)
    return result


def plot_optimization_history(
    history_jsons: Sequence[str],
    out_png: str,
    compare_to_paper: bool = True,
) -> None:
    """Bar plot of final stability/MAE per property vs the paper's values."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    rows = []
    for path in history_jsons:
        with open(path) as f:
            data = json.load(f)
        rows.append((data["property"], data["final"]))

    props = [r[0] for r in rows]
    ours_stab = [r[1]["mol_stable"] for r in rows]
    ours_mae = [r[1]["mae"] for r in rows]

    fig, axes = plt.subplots(1, 2, figsize=(12, 4))
    x = np.arange(len(props))
    axes[0].bar(x - 0.2, ours_stab, 0.4, label="ours")
    if compare_to_paper:
        paper = [PAPER_OPT_100_STEPS.get(p, {}).get("mol_stable", np.nan) for p in props]
        axes[0].bar(x + 0.2, paper, 0.4, label="GCDM-Opt (paper)")
    axes[0].set_xticks(x)
    axes[0].set_xticklabels(props)
    axes[0].set_ylabel("molecule stability")
    axes[0].legend()

    axes[1].bar(x - 0.2, ours_mae, 0.4, label="ours")
    if compare_to_paper:
        paper = [PAPER_OPT_100_STEPS.get(p, {}).get("mae", np.nan) for p in props]
        axes[1].bar(x + 0.2, paper, 0.4, label="GCDM-Opt (paper)")
    axes[1].set_xticks(x)
    axes[1].set_xticklabels(props)
    axes[1].set_ylabel("classifier MAE")
    axes[1].legend()
    fig.tight_layout()
    fig.savefig(out_png, dpi=120)
    plt.close(fig)
