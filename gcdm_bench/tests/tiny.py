"""A copy of the benchmark's data files at a tiny width and size, for runs
of the whole harness on the CPU (the program's plain message layer)."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from gcdm_bench.harness import REPO, ROOT

TINY_MODEL = dict(h_hidden_dim=16, chi_hidden_dim=4, e_hidden_dim=8, xi_hidden_dim=2, num_encoder_layers=2)


def tiny_root(dest: Path, published_widths: bool = False) -> Path:
    """``dest`` holding the benchmark's files with tiny batches (and tiny
    widths, unless ``published_widths``), and its ``BENCHMARK.json``."""
    for d in ("configs", "traffic", "limits", "metrics", "histograms", "drivers"):
        shutil.copytree(ROOT / d, dest / d)
    shutil.copy(ROOT / "peaks.json", dest / "peaks.json")
    for path in (dest / "configs").glob("*.json"):
        cfg = json.loads(path.read_text())
        if not published_widths:
            cfg["model_cfg"].update(TINY_MODEL)
        path.write_text(json.dumps(cfg))
    for path in (dest / "traffic").glob("*.json"):
        spec = json.loads(path.read_text())
        if spec["kind"] == "sample":
            spec.update(batch_size=4, num_timesteps=3, batches=3, checked_molecules=4)
        else:
            spec.update(batch_size=4, epoch_batches=5, reference_rows=20000)
        path.write_text(json.dumps(spec))
    shutil.copy(REPO / "BENCHMARK.json", dest / "BENCHMARK.json")
    return dest


def execute(root: Path, workload: str, seed: int = 2 ** 31 + 17, trace: int = 0, fault=None, manifest=None,
            device="cpu", control: bool = False):
    from gcdm_bench import run

    args = run.parse(["--workload", workload, "--seed", str(seed), "--seconds", "0.2", "--trace", str(trace),
                      "--manifest", str(manifest or root / "BENCHMARK.json")] + (["--control"] if control else []))
    return run.execute(args, device=device, root=root, fault=fault)
