"""Evaluation entry point (PyTorch).

Port of ``bio_diffusion_tpu/cli/mol_gen_eval.py``.  Samples ``num_samples``
molecules, reports stability and atom-type KL (validity, uniqueness and
novelty too when RDKit imports), and the test NLL averaged over
``num_test_passes`` passes over the test split; writes
``<output_dir>/eval_results.json``.

Usage:
  python -m bio_diffusion_torch.cli.mol_gen_eval ckpt_path=<ckpt> \\
      [experiment=geom_mol_gen_ddpm] [device=cuda|cpu] [num_samples=10000] [sampling_batch_size=100] \\
      [num_test_passes=5] [evaluate_nll=true] [fast_nll=false] \\
      [save_molecules=false] [precision=fp32|bf16] [output_dir=DIR] [k=v ...]

``ckpt_path`` takes what ``mol_gen_sample`` takes.  The NLL runs at
``precision``; ``fast_nll=true`` runs it with the bf16 network body
whatever ``precision`` says.  Without the dataset's files the NLL is skipped
with a warning.  Novelty (with RDKit only) reads the training SMILES of
``smiles_filepath``: QM9's ``.npy`` or GEOM-Drugs' ``.txt``.  ``device`` defaults to ``cuda``; there is no fallback to
the CPU.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
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
from bio_diffusion_torch.config.build import build_datasets, build_evd, build_experiment, get_dataset_info_for
from bio_diffusion_torch.data.batch import iterate_dense_batches
from bio_diffusion_torch.train.sampling import SegmentedSampler, analyze_samples, sample_molecules
from bio_diffusion_torch.train.step import make_eval_step
from bio_diffusion_torch.utils.logging import get_logger

log = get_logger(__name__)


def nll_passes(cfg, exp, evd, device, nodes_dist, rng):
    """The mean NLL over the test split per pass -> list of ``num_test_passes``
    floats, or None when the dataset's files are missing."""
    try:
        datasets = build_datasets(exp)
    except (RuntimeError, FileNotFoundError) as e:
        log.warning("Skipping NLL evaluation (dataset unavailable): %s", e)
        return None
    nll_evd = evd
    if cfg.get("fast_nll", False) and exp.trainer.precision != "bf16":
        nll_evd = build_evd(build_experiment(with_precision(cfg, "bf16")))
        nll_evd.load_state_dict(evd.state_dict())
        nll_evd = nll_evd.to(device).eval()
        log.info("NLL evaluation with the bf16 network body")
    eval_step = make_eval_step(nll_evd, exp.diffusion_cfg, exp.dataloader_cfg, nodes_dist.log_prob_table)
    generator = torch.Generator(device=device).manual_seed(exp.seed + 1)
    test = datasets["test"]
    passes = []
    for _ in range(int(cfg.get("num_test_passes", 5))):
        losses = [eval_step(batch.to(device), generator)["loss"]
                  for batch in iterate_dense_batches(test, exp.dataloader_cfg.batch_size, rng=rng, shuffle=False,
                                                     drop_last=False, pad_to=test.data["positions"].shape[1])]
        passes.append(float(torch.stack(losses).float().mean()))
    return passes


def main(argv=None):
    cfg, _ = parse_cli(list(sys.argv[1:] if argv is None else argv), "mol_gen_eval", __doc__)
    exp = build_experiment(with_precision(cfg, precision_of(cfg)))
    device = device_of(cfg)
    dataset_info = get_dataset_info_for(exp)
    nodes_dist = nodes_distribution_for(exp)

    evd = load_model(exp, cfg.get("ckpt_path"), device, seed=exp.seed)
    rng = np.random.default_rng(exp.seed)
    generator = torch.Generator(device=device).manual_seed(exp.seed)

    num_timesteps = cfg.get("num_timesteps")
    xh, node_mask, _ = sample_molecules(
        SegmentedSampler(evd, device), generator, int(cfg.get("num_samples", 10000)), nodes_dist, rng,
        batch_size=int(cfg.get("sampling_batch_size", 100)),
        num_timesteps=int(num_timesteps) if num_timesteps else None)
    metrics = analyze_samples(
        xh, node_mask, dataset_info, include_charges=exp.dataloader_cfg.include_charges,
        molecular_metrics=build_molecular_metrics(dataset_info, exp.dataloader_cfg.smiles_filepath))

    # test NLL over multiple passes (reference mol_gen_eval.py:172-186)
    if cfg.get("evaluate_nll", True):
        passes = nll_passes(cfg, exp, evd, device, nodes_dist, rng)
        if passes is not None:
            metrics["test_nll"] = float(np.mean(passes))
            metrics["test_nll_passes"] = passes

    out_dir = str(cfg.get("output_dir", "outputs/mol_gen_eval"))
    os.makedirs(out_dir, exist_ok=True)
    if cfg.get("save_molecules", False):
        # the sampled set for an offline analysis stage (ref mol_gen_eval.py)
        from bio_diffusion_torch.chem.molecule import save_xyz_files

        k = len(dataset_info["atom_decoder"])
        files = save_xyz_files(os.path.join(out_dir, "molecules"), xh[..., :3], xh[..., 3:3 + k],
                               node_mask, dataset_info)
        log.info("Saved %d sampled molecules", len(files))
    with open(os.path.join(out_dir, "eval_results.json"), "w") as f:
        json.dump(metrics, f, indent=2)
    log.info("Evaluation metrics: %s", metrics)
    print(json.dumps(metrics))
    return metrics


if __name__ == "__main__":
    main()
