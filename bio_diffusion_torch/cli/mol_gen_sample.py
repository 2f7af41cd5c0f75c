"""Molecule sampling entry point (PyTorch).

Port of ``bio_diffusion_tpu/cli/mol_gen_sample.py`` (``ddpm_mode=
unconditional``).  Composes ``configs/mol_gen_sample.yaml`` with the port's
config loader.

Usage:
  python -m bio_diffusion_torch.cli.mol_gen_sample ckpt_path=<ckpt> \\
      [experiment=geom_mol_gen_ddpm] [device=cuda|cpu] [num_samples=250] [num_nodes=19] \\
      [sampling_batch_size=100] [num_timesteps=1000] [precision=fp32|bf16] \\
      [output_dir=DIR] [k=v ...]

``ckpt_path`` is a reference ``.ckpt``, a checkpoint directory of the port's
Trainer (its EMA weights) or a params file; ``null`` samples from weights
drawn from ``seed``.  ``num_nodes`` fixes every molecule's size; without it
sizes are drawn from the dataset's size distribution (QM9's, or GEOM-Drugs'
3..181 atoms with ``experiment=geom_mol_gen_ddpm``) and sampled in
``sampling_batch_size`` batches.  ``device`` defaults to ``cuda``; there is
no fallback to the CPU.

Writes one .xyz per molecule (and one .sdf when RDKit imports) under
``<output_dir>/<timestamp>`` and prints the stability metrics of the
generated set.  The modes ``inpainting``, ``chain`` and ``pocket`` are not
ported yet.
"""

from __future__ import annotations

import datetime
import os
import sys

import numpy as np
import torch

from bio_diffusion_torch.chem.molecule import RDKIT_AVAILABLE, save_xyz_files
from bio_diffusion_torch.cli.common import (
    device_of,
    load_model,
    nodes_distribution_for,
    parse_cli,
    precision_of,
    with_precision,
)
from bio_diffusion_torch.config.build import build_experiment, get_dataset_info_for
from bio_diffusion_torch.train.sampling import SegmentedSampler, analyze_samples, make_node_mask, sample_molecules
from bio_diffusion_torch.utils.logging import get_logger

log = get_logger(__name__)

UNPORTED_MODES = {"inpainting": "A10", "chain": "A4", "pocket": "A10"}


def main(argv=None):
    cfg, _ = parse_cli(list(sys.argv[1:] if argv is None else argv), "mol_gen_sample", __doc__)
    ddpm_mode = cfg.get("ddpm_mode", "unconditional")
    if ddpm_mode in UNPORTED_MODES:
        raise NotImplementedError(f"ddpm_mode={ddpm_mode} is not ported yet (ROADMAP {UNPORTED_MODES[ddpm_mode]})")
    if ddpm_mode != "unconditional":
        raise ValueError(f"unknown ddpm_mode {ddpm_mode!r}")
    # reference arg names accepted as aliases (ref mol_gen_sample.py:173-177)
    if "all_frags" in cfg:
        cfg["largest_frag"] = not bool(cfg["all_frags"])
    if cfg.get("relax") and not cfg.get("relax_iter"):
        cfg["relax_iter"] = 200
    exp = build_experiment(with_precision(cfg, precision_of(cfg)))
    device = device_of(cfg)
    dataset_info = get_dataset_info_for(exp)
    nodes_dist = nodes_distribution_for(exp)

    evd = load_model(exp, cfg.get("ckpt_path"), device, seed=exp.seed)
    sampler = SegmentedSampler(evd, device)
    rng = np.random.default_rng(exp.seed)
    generator = torch.Generator(device=device).manual_seed(exp.seed)

    num_samples = int(cfg.get("num_samples", 250))
    num_timesteps = cfg.get("num_timesteps")
    num_timesteps = int(num_timesteps) if num_timesteps else None
    out_dir = os.path.join(str(cfg.get("output_dir", "outputs/mol_gen_sample")),
                           datetime.datetime.now().strftime("%Y%m%d_%H%M%S"))

    num_nodes = cfg.get("num_nodes")
    if num_nodes:
        node_mask = make_node_mask(np.full(num_samples, int(num_nodes)), int(num_nodes))
        xh = sampler.run(node_mask, generator, num_timesteps=num_timesteps)
    else:
        xh, node_mask, _ = sample_molecules(
            sampler, generator, num_samples, nodes_dist, rng,
            batch_size=min(num_samples, int(cfg.get("sampling_batch_size", 100))),
            num_timesteps=num_timesteps)

    k = len(dataset_info["atom_decoder"])
    files = save_xyz_files(out_dir, xh[..., :3], xh[..., 3:3 + k], node_mask, dataset_info)
    log.info("Wrote %d xyz files to %s", len(files), out_dir)

    if RDKIT_AVAILABLE:
        from bio_diffusion_torch.chem.molecule import build_molecule, process_molecule, write_sdf_file

        mols = []
        for i in range(len(xh)):
            m = node_mask[i] > 0
            mol = build_molecule(xh[i, :, :3][m], xh[i, :, 3:3 + k][m].argmax(-1), dataset_info)
            mol = process_molecule(
                mol,
                add_hydrogens=bool(cfg.get("add_hydrogens", False)),
                sanitize=bool(cfg.get("sanitize", False)),
                relax_iter=int(cfg.get("relax_iter", 0)),
                largest_frag=bool(cfg.get("largest_frag", False)),
            )
            if mol is not None:
                mols.append(mol)
        sdf_path = os.path.join(out_dir, "molecules.sdf")
        write_sdf_file(sdf_path, mols)
        log.info("Wrote %d molecules to %s", len(mols), sdf_path)

    metrics = analyze_samples(xh, node_mask, dataset_info, exp.dataloader_cfg.include_charges)
    log.info("Sample metrics: %s", metrics)
    print(metrics)
    return metrics


if __name__ == "__main__":
    main()
