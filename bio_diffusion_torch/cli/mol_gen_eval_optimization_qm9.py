"""Guided property-optimization evaluation (PyTorch).

Port of ``bio_diffusion_tpu/cli/mol_gen_eval_optimization_qm9.py``.  Two
phases:

1. Starting molecules: 19-atom molecules from the unconditional model with
   few (``num_gen_timesteps``) reverse steps, deliberately rough, or the
   xyz files of ``pregenerated_molecules_dir``.  ``generate_molecules_only``
   stops here.
2. ``iterations`` round trips of every molecule through the last
   ``num_optimization_timesteps`` reverse steps of the property-conditioned
   model (``EquivariantVariationalDiffusion.mol_gen_optimize``) with one
   fixed context per molecule; after each, the molecules' stability and the
   classifier's MAE against the contexts.  Writes
   ``<output_dir>/optimization_eval_<property>.json``.

Usage:
  python -m bio_diffusion_torch.cli.mol_gen_eval_optimization_qm9 \\
      unconditional_generator_model_filepath=<ckpt> \\
      conditional_generator_model_filepath=<ckpt> classifier_model_dir=<dir> \\
      property=alpha [iterations=10] [num_samples=1000] [batch_size=100] \\
      [num_gen_timesteps=10] [num_optimization_timesteps=100] \\
      [use_pregenerated_molecules=false pregenerated_molecules_dir=DIR] \\
      [generate_molecules_only=false] [save_molecules=true] \\
      [device=cuda|cpu] [precision=fp32|bf16] [output_dir=DIR] [k=v ...]

Checkpoints take what ``mol_gen_sample``'s ``ckpt_path`` takes (none: weights
drawn from the seed, with a warning); the classifier is loaded as the
conditional evaluation CLI loads it.  ``device`` defaults to ``cuda``; there
is no fallback to the CPU.
"""

from __future__ import annotations

import copy
import json
import os
import sys

import numpy as np
import torch

from bio_diffusion_torch.chem.stability import batch_molecular_stability
from bio_diffusion_torch.cli.common import device_of, load_model, parse_cli, precision_of, with_precision
from bio_diffusion_torch.cli.mol_gen_eval_conditional_qm9 import (
    apply_conditional_surgery,
    classify,
    load_classifier,
)
from bio_diffusion_torch.config.build import build_datasets, build_experiment, get_dataset_info_for
from bio_diffusion_torch.data.batch import broadcast_context
from bio_diffusion_torch.models.distributions import property_normalizers
from bio_diffusion_torch.ops.geometry import centralize
from bio_diffusion_torch.train.sampling import SegmentedSampler, make_node_mask
from bio_diffusion_torch.utils.logging import get_logger

log = get_logger(__name__)

FIXED_NUM_NODES = 19  # the reference protocol's starting molecules


def load_pregenerated(pregen_dir: str, num_samples: int, dataset_info):
    """The first ``num_samples`` xyz files of ``pregen_dir`` (sorted) ->
    ``(x [M, N, 3], one_hot [M, N, K], node_mask [M, N])``, padded to the
    largest."""
    from bio_diffusion_torch.chem.molecule import load_molecule_xyz

    files = sorted(os.path.join(pregen_dir, f) for f in os.listdir(pregen_dir) if f.endswith(".xyz"))[:num_samples]
    mols = [load_molecule_xyz(path, dataset_info) for path in files]
    sizes = np.array([len(p) for p, _ in mols])
    pad, k = int(sizes.max()), len(dataset_info["atom_decoder"])
    x0 = np.zeros((len(mols), pad, 3), np.float32)
    oh0 = np.zeros((len(mols), pad, k), np.float32)
    for i, (p, oh) in enumerate(mols):
        x0[i, :len(p)], oh0[i, :len(p)] = p, oh
    return x0, oh0, make_node_mask(sizes, pad)


def main(argv=None):
    cfg, _ = parse_cli(list(sys.argv[1:] if argv is None else argv), "mol_gen_eval_optimization_qm9", __doc__)
    prop = str(cfg.get("property", "alpha"))
    batch_size = int(cfg.get("batch_size", 100))
    num_samples = int(cfg.get("num_samples", 1000))
    iterations = int(cfg.get("iterations", 10))
    num_gen_timesteps = int(cfg.get("num_gen_timesteps", 10))
    num_opt_timesteps = int(cfg.get("num_optimization_timesteps", 100))
    out_root = str(cfg.get("output_dir", "outputs/mol_gen_eval_optimization_qm9"))
    cfg = with_precision(cfg, precision_of(cfg))
    device = device_of(cfg)
    uncond_exp = build_experiment(copy.deepcopy(cfg))
    seed = uncond_exp.seed
    rng = np.random.default_rng(seed)
    generator = torch.Generator(device=device).manual_seed(seed)
    dataset_info = get_dataset_info_for(uncond_exp)
    k_types = len(dataset_info["atom_decoder"])

    # ---- phase 1: the starting molecules ----
    pregen_dir = cfg.get("pregenerated_molecules_dir")
    if cfg.get("use_pregenerated_molecules") and pregen_dir:
        x0, oh0, node_mask_np = load_pregenerated(str(pregen_dir), num_samples, dataset_info)
    else:
        node_mask_np = make_node_mask(np.full(num_samples, FIXED_NUM_NODES), FIXED_NUM_NODES)
        evd_u = load_model(uncond_exp, cfg.get("unconditional_generator_model_filepath"), device, seed=seed)
        sampler_u = SegmentedSampler(evd_u, device)
        xs = [sampler_u.run(node_mask_np[start: start + batch_size], generator, num_timesteps=num_gen_timesteps)
              for start in range(0, num_samples, batch_size)]
        x0 = np.concatenate([xh[..., :3] for xh in xs])
        oh0 = np.concatenate([xh[..., 3:3 + k_types] for xh in xs])
        if cfg.get("save_molecules", True):
            from bio_diffusion_torch.chem.molecule import save_xyz_files

            save_xyz_files(os.path.join(out_root, "initial_molecules"), x0, oh0, node_mask_np, dataset_info)
    if cfg.get("generate_molecules_only"):
        print(json.dumps({"generated": int(len(x0))}))
        return {"generated": int(len(x0))}

    # ---- phase 2: guided round trips through the conditional model ----
    cond_exp = build_experiment(apply_conditional_surgery(copy.deepcopy(cfg), prop))
    evd_c = load_model(cond_exp, cfg.get("conditional_generator_model_filepath") or cfg.get("ckpt_path"), device,
                       seed=seed)
    norms, props_distr = property_normalizers(build_datasets(cond_exp), (prop,), cond_exp.dataloader_cfg.dataset)
    mean, mad = norms[prop]["mean"], norms[prop]["mad"]
    classifier, cls_meta = load_classifier(cfg.get("classifier_model_dir"), prop, device)
    cls_mean, cls_mad = float(cls_meta.get("mean", mean)), float(cls_meta.get("mad", mad))

    # one fixed context per molecule for the whole optimization
    ctx_norm = props_distr.sample_batch(node_mask_np.sum(-1).astype(int), rng)
    target = ctx_norm[:, 0] * mad + mean
    node_mask = torch.as_tensor(node_mask_np, device=device)
    context = torch.as_tensor(broadcast_context(ctx_norm, node_mask_np), device=device)
    x_cur = torch.as_tensor(x0, device=device)
    oh_cur = torch.as_tensor(oh0, device=device)
    history = []
    for it in range(iterations):
        _, x_cur = centralize(x_cur, node_mask)  # the round trip takes CoM-free positions
        with torch.inference_mode():
            out = torch.cat([
                evd_c.mol_gen_optimize(x_cur[sl], oh_cur[sl], node_mask[sl], num_opt_timesteps, context[sl],
                                       generator=generator)
                for sl in (slice(s, s + batch_size) for s in range(0, len(x0), batch_size))])
        x_cur, oh_cur = out[..., :3], out[..., 3:3 + k_types]
        out_np = out.float().cpu().numpy()
        mol_stable, stable_atoms, num_atoms = batch_molecular_stability(
            out_np[..., :3], out_np[..., 3:3 + k_types].argmax(-1), node_mask_np, dataset_info)
        pred = classify(classifier, out_np[..., 3:3 + k_types], out_np[..., :3], node_mask_np, device)
        entry = {"iteration": it + 1, "mol_stable": float(mol_stable.mean()),
                 "atm_stable": float(stable_atoms.sum() / max(num_atoms.sum(), 1)),
                 "mae": float(np.abs(cls_mad * pred + cls_mean - target).mean())}
        history.append(entry)
        log.info("optimization %s", entry)

    result = {"property": prop, "history": history, "final": history[-1] if history else None}
    os.makedirs(out_root, exist_ok=True)
    with open(os.path.join(out_root, f"optimization_eval_{prop}.json"), "w") as f:
        json.dump(result, f, indent=2)
    print(json.dumps(result["final"]))
    return result


if __name__ == "__main__":
    main()
