"""Molecule sampling entry point (PyTorch).

Port of ``bio_diffusion_tpu/cli/mol_gen_sample.py`` (``ddpm_mode=
unconditional``, ``inpainting``, ``pocket`` and ``chain``).  Composes
``configs/mol_gen_sample.yaml`` with the port's config loader.

Usage:
  python -m bio_diffusion_torch.cli.mol_gen_sample ckpt_path=<ckpt> \\
      [experiment=geom_mol_gen_ddpm|pocket_mol_gen_ddpm] [device=cuda|cpu] [num_samples=250] \\
      [num_nodes=19] [sampling_batch_size=100] [num_timesteps=1000] [precision=fp32|bf16] \\
      [ddpm_mode=unconditional|inpainting|pocket|chain] [num_resamplings=1] [jump_length=1] \\
      [keep_frames=100] [output_dir=DIR] [k=v ...]

``ckpt_path`` is a reference ``.ckpt``, a checkpoint directory of the port's
Trainer (its EMA weights) or a params file; ``null`` samples from weights
drawn from ``seed``.  ``num_nodes`` fixes every molecule's size; without it
sizes are drawn from the dataset's size distribution (QM9's, or GEOM-Drugs'
3..181 atoms with ``experiment=geom_mol_gen_ddpm``) and sampled in
``sampling_batch_size`` batches.  ``device`` defaults to ``cuda``; there is
no fallback to the CPU.

``ddpm_mode=inpainting`` fixes the first node of every molecule at the
origin and generates the rest by RePaint (``num_resamplings``,
``jump_length``), all molecules in one batch.  ``ddpm_mode=pocket``
generates ligands into protein pockets by RePaint over the joint
ligand+pocket graph with the pocket rows fixed (with
``experiment=pocket_mol_gen_ddpm``): ``pocket_file=<.pdb>`` takes the CA
atoms of a structure (``pocket_chain=``, ``pocket_center=[x,y,z]`` with
``pocket_radius=``, or ``pocket_ligand=<HETATM resname>`` cut out the
binding site), ``pocket_file=<.json>`` gives ``{"coords": [[x,y,z], ...],
"residues": ["A", ...]}``, otherwise synthetic shell pockets stand in
(``pocket_size=`` fixes their size); ligand sizes come from the joint size
histogram of ``pocket_dataset`` given each pocket's size, or
``num_nodes``.  The pocket mode scores the ligands in the ligand atom
space, adds ``lig_nn_dist`` and ``lig_center_rms``, and writes the pockets
to ``pockets.json`` beside the xyz files.  Sizes and pockets come from
``np.random.default_rng(seed)`` in the JAX package's order, so they equal
its own for the same seed.

``ddpm_mode=chain`` samples one molecule (``num_nodes`` atoms, or a size
drawn from the dataset's distribution) and keeps its denoising chain: the
states after every ``max(1, T // keep_frames)``-th reverse step (default
``keep_frames=100``) are gathered on the device, written as
``<out>/chain/chain_*.xyz`` with the last kept frame repeated 10 times, and
rendered to ``<out>/chain/output.gif`` where matplotlib and imageio are
installed (otherwise the run logs why no GIF was made and goes on).

Writes one .xyz per molecule (and one .sdf when RDKit imports) under
``<output_dir>/<timestamp>`` and prints the stability metrics of the
generated set.
"""

from __future__ import annotations

import datetime
import json
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
from bio_diffusion_torch.config.build import POCKET_DATASETS, build_experiment, get_dataset_info_for
from bio_diffusion_torch.data.pocket import (
    get_pocket_dataset_info,
    ligand_dataset_info,
    load_pocket_pdb,
    sample_joint_sizes,
    synthetic_pockets,
)
from bio_diffusion_torch.train.sampling import (
    SegmentedSampler,
    analyze_samples,
    generate_ligands_in_pocket,
    ligand_pocket_geometry,
    make_node_mask,
    sample_molecules,
)
from bio_diffusion_torch.utils.logging import get_logger

log = get_logger(__name__)

MODES = ("unconditional", "inpainting", "pocket", "chain")


def main(argv=None):
    cfg, _ = parse_cli(list(sys.argv[1:] if argv is None else argv), "mol_gen_sample", __doc__)
    ddpm_mode = cfg.get("ddpm_mode", "unconditional")
    if ddpm_mode not in MODES:
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
    rng = np.random.default_rng(exp.seed)
    generator = torch.Generator(device=device).manual_seed(exp.seed)

    num_samples = int(cfg.get("num_samples", 250))
    num_timesteps = cfg.get("num_timesteps")
    num_timesteps = int(num_timesteps) if num_timesteps else None
    num_nodes = cfg.get("num_nodes")
    extra_metrics: dict = {}
    out_dir = os.path.join(str(cfg.get("output_dir", "outputs/mol_gen_sample")),
                           datetime.datetime.now().strftime("%Y%m%d_%H%M%S"))

    if ddpm_mode == "inpainting":
        sizes = np.full(num_samples, int(num_nodes)) if num_nodes else nodes_dist.sample(num_samples, rng)
        xh, node_mask = inpaint_first_node(evd, cfg, sizes, len(dataset_info["atom_decoder"]), num_timesteps,
                                           generator)
    elif ddpm_mode == "pocket":
        xh, node_mask, dataset_info, extra_metrics = sample_in_pockets(
            evd, cfg, exp, num_samples, num_nodes, num_timesteps, rng, generator, out_dir)
    elif ddpm_mode == "chain":
        sizes = np.full(1, int(num_nodes)) if num_nodes else nodes_dist.sample(1, rng)
        node_mask = make_node_mask(sizes, int(sizes.max()))
        xh = sample_chain(SegmentedSampler(evd, device), node_mask, generator, num_timesteps or evd.T,
                          int(cfg.get("keep_frames", 100)), dataset_info, os.path.join(out_dir, "chain"))
    elif num_nodes:
        node_mask = make_node_mask(np.full(num_samples, int(num_nodes)), int(num_nodes))
        xh = SegmentedSampler(evd, device).run(node_mask, generator, num_timesteps=num_timesteps)
    else:
        xh, node_mask, _ = sample_molecules(
            SegmentedSampler(evd, device), generator, num_samples, nodes_dist, rng,
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
    metrics.update(extra_metrics)
    log.info("Sample metrics: %s", metrics)
    print(metrics)
    return metrics


def sample_chain(sampler: SegmentedSampler, node_mask, generator, num_timesteps: int, keep_frames: int,
                 dataset_info, chain_dir: str, noises=None):
    """One batch sampled with its denoising chain kept: the frames that
    ``save_chain_frames`` selects for molecule 0 go to ``chain_dir`` as xyz
    files, and a GIF where it can be rendered -> the decoded ``xh``."""
    from bio_diffusion_torch.chem.visualization import (
        can_render, chain_frame_steps, save_chain_frames, visualize_chain,
    )

    steps = chain_frame_steps(num_timesteps, keep_frames)
    xh, frames = sampler.run(node_mask, generator, num_timesteps, noises=noises, frame_steps=steps)
    save_chain_frames(frames[:, 0], node_mask[0], dataset_info, chain_dir, keep_frames=len(steps))
    if can_render():
        visualize_chain(chain_dir, dataset_info)
    return xh


def inpaint_first_node(evd, cfg, sizes, num_atom_types: int, num_timesteps, generator):
    """Molecules of ``sizes`` in one batch, each with its first node fixed
    at the origin (the reference's default fixed point), the rest inpainted
    -> host ``(xh, node_mask)``."""
    device = next(evd.parameters()).device
    b, pad = len(sizes), int(sizes.max())
    node_mask = make_node_mask(sizes, pad)
    fixed = np.zeros((b, pad), np.float32)
    fixed[:, 0] = 1.0
    with torch.inference_mode():
        xh = evd.inpaint(torch.zeros((b, pad, 3), device=device), torch.zeros((b, pad, num_atom_types), device=device),
                         torch.zeros((b, pad, 1), device=device), torch.as_tensor(node_mask, device=device),
                         torch.as_tensor(fixed, device=device), int(cfg.get("num_resamplings", 1)),
                         int(cfg.get("jump_length", 1)), num_timesteps, generator=generator)
    return xh.cpu().numpy(), node_mask


def load_pocket_file(cfg, pocket_name: str, aa_encoder):
    """One pocket from ``pocket_file`` (.pdb or .json) -> (coords [P, 3], residue types [P])."""
    path = str(cfg["pocket_file"])
    if path.lower().endswith(".pdb"):
        center = cfg.get("pocket_center")
        return load_pocket_pdb(path, pocket_name, chain=cfg.get("pocket_chain"),
                               center=np.asarray(center, np.float32) if center else None,
                               radius=float(cfg["pocket_radius"]) if cfg.get("pocket_radius") else None,
                               ligand_resname=cfg.get("pocket_ligand"))
    with open(path) as f:
        spec = json.load(f)
    residues = [r if isinstance(r, int) else aa_encoder[str(r)] for r in spec["residues"]]
    return np.asarray(spec["coords"], dtype=np.float32), np.asarray(residues, dtype=np.int64)


def sample_in_pockets(evd, cfg, exp, num_samples: int, num_nodes, num_timesteps, rng, generator, out_dir):
    """Ligands generated into ``num_samples`` pockets (one from
    ``pocket_file`` repeated, or synthetic ones), sizes and pockets drawn
    from ``rng`` in the JAX package's order; writes ``pockets.json`` ->
    ``(xh, ligand_mask, ligand dataset info, geometry metrics)``."""
    pocket_name = str(cfg.get("pocket_dataset") or (
        exp.dataloader_cfg.dataset if exp.dataloader_cfg.dataset in POCKET_DATASETS else "bindingmoad"))
    pinfo = get_pocket_dataset_info(pocket_name)
    if cfg.get("pocket_file"):
        px1, pa1 = load_pocket_file(cfg, pocket_name, pinfo["aa_encoder"])
        pocket_x = np.broadcast_to(px1, (num_samples,) + px1.shape).copy()
        pocket_aa = np.broadcast_to(pa1, (num_samples,) + pa1.shape).copy()
        pocket_mask = np.ones((num_samples, len(px1)), np.float32)
        pocket_sizes = np.full(num_samples, len(px1))
    else:
        log.warning("No pocket_file given: synthetic shell pockets stand in (give pocket_file for real structures)")
        psize = cfg.get("pocket_size")
        if psize:
            pocket_sizes = np.full(num_samples, int(psize))
        else:
            _, pocket_sizes = sample_joint_sizes(pocket_name, num_samples, rng)
        pocket_x, pocket_aa, pocket_mask = synthetic_pockets(pocket_name, pocket_sizes, rng)
    if num_nodes:
        ligand_sizes = np.full(num_samples, int(num_nodes))
    else:
        # each pocket's ligand size from its column of the joint histogram
        max_col = np.asarray(pinfo["n_nodes"]).shape[1] - 1
        ligand_sizes = np.array([sample_joint_sizes(pocket_name, 1, rng, pocket_size=int(min(s, max_col)))[0][0]
                                 for s in pocket_sizes])
    out = generate_ligands_in_pocket(
        evd, generator, pocket_x, pocket_aa, pocket_mask, ligand_sizes, len(pinfo["atom_decoder"]),
        num_resamplings=int(cfg.get("num_resamplings", 1)), jump_length=int(cfg.get("jump_length", 1)),
        num_timesteps=num_timesteps)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "pockets.json"), "w") as f:
        json.dump({"coords": pocket_x.tolist(), "residue_index": pocket_aa.tolist(), "mask": pocket_mask.tolist(),
                   "dataset": pocket_name}, f)
    xh = np.concatenate([out["ligand_x"], out["ligand_one_hot"]], axis=-1)
    geometry = ligand_pocket_geometry(out["ligand_x"], out["ligand_mask"], pocket_x, pocket_mask)
    return xh, out["ligand_mask"], ligand_dataset_info(pocket_name), geometry


if __name__ == "__main__":
    main()
