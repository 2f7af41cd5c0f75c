"""Pocket-path quality: does the trained joint model generate into pockets?

Port of ``scripts/bench_pocket_quality.py``.  Trains the unconditional joint
ligand+pocket model (``experiment=pocket_mol_gen_ddpm``, the model RePaint
pocket conditioning samples from) on the synthetic joint dataset through
``cli.train``, then generates ligands into synthetic pockets through
``cli.mol_gen_sample ddpm_mode=pocket`` from the trained checkpoint and
from weights drawn from the seed, and scores both beside the dataset's own
ligands.  Valence stability tells nothing on the synthetic random-walk
ligands (their own chains score ~0); ``lig_nn_dist`` and
``lig_center_rms`` (``train.sampling.ligand_pocket_geometry``) tell
trained from untrained.

  python -m bio_diffusion_torch.cli.bench_pocket_quality [device=cuda|cpu]
  POCKET_STEPS=400 POCKET_SAMPLES=100 POCKET_TIMESTEPS=250 POCKET_BATCH=32 \\
      python -m bio_diffusion_torch.cli.bench_pocket_quality

Environment: ``POCKET_PRESET`` = ``full`` (the published pocket width, 2,500
steps at batch 16, 100 samples at T=250), ``mid`` (a half-width model, two
buckets) or ``tiny`` (a CPU smoke run); ``POCKET_STEPS``,
``POCKET_SAMPLES``, ``POCKET_TIMESTEPS``, ``POCKET_BATCH`` and
``POCKET_WORKDIR`` override the preset.  ``device`` defaults to ``cuda``;
there is no fallback to the CPU.

Prints one JSON line: ``{"device": ..., "steps": N, "final_loss": ...,
"first_loss": ..., "data": {...}, "trained": {...}, "random": {...}}``,
each row with ``atm_stable``, ``mol_stable``, ``kl_div_atom_types``,
``lig_nn_dist`` and ``lig_center_rms`` (``validity`` too with RDKit).
"""

from __future__ import annotations

import json
import os
import sys
import tempfile

import numpy as np

KEYS = ("atm_stable", "mol_stable", "validity", "kl_div_atom_types", "lig_nn_dist", "lig_center_rms")

MID = [
    "model.model_cfg.h_hidden_dim=128",
    "model.model_cfg.chi_hidden_dim=16",
    "model.model_cfg.e_hidden_dim=8",
    "model.model_cfg.xi_hidden_dim=4",
    "model.model_cfg.num_encoder_layers=2",
    "model.model_cfg.num_decoder_layers=2",
    "datamodule.dataloader_cfg.bucket_sizes=[64,144]",
]
TINY = [
    "datamodule.dataloader_cfg.num_train=24",
    "datamodule.dataloader_cfg.num_valid=8",
    "datamodule.dataloader_cfg.num_test=8",
    "model.model_cfg.h_hidden_dim=16",
    "model.model_cfg.chi_hidden_dim=4",
    "model.model_cfg.e_hidden_dim=8",
    "model.model_cfg.xi_hidden_dim=2",
    "model.model_cfg.num_encoder_layers=1",
    "model.diffusion_cfg.num_timesteps=8",
]


def data_row(dataset: str = "bindingmoad", num_graphs: int = 128, seed: int = 0):
    """The same metrics on the synthetic joint dataset's own ligands."""
    from bio_diffusion_torch.data.pocket import ligand_dataset_info, synthetic_pocket_joint_dataset
    from bio_diffusion_torch.train.sampling import analyze_samples, ligand_pocket_geometry

    ds = synthetic_pocket_joint_dataset(dataset, num_graphs=num_graphs, seed=seed)
    info = ligand_dataset_info(dataset)
    kl = len(info["atom_decoder"])
    nl_arr = ds.data["num_ligand_atoms"]
    b, n_pad = len(nl_arr), ds.data["positions"].shape[1]
    gx = np.zeros((b, int(nl_arr.max()), 3), np.float32)
    gh = np.zeros((b, int(nl_arr.max()), kl), np.float32)
    gm = np.zeros((b, int(nl_arr.max())), np.float32)
    px = np.zeros((b, n_pad, 3), np.float32)
    pm = np.zeros((b, n_pad), np.float32)
    for i, nl in enumerate(nl_arr):
        nl, npk = int(nl), int(ds.data["num_atoms"][i]) - int(nl)
        gx[i, :nl] = ds.data["positions"][i, :nl]
        gh[i, :nl] = ds.data["one_hot"][i, :nl, :kl]
        gm[i, :nl] = 1.0
        px[i, :npk] = ds.data["positions"][i, nl: nl + npk]
        pm[i, :npk] = 1.0
    row = analyze_samples(np.concatenate([gx, gh], -1), gm, info, include_charges=False)
    row.update(ligand_pocket_geometry(gx, gm, px, pm))
    return row


def main(argv=None):
    import torch

    from bio_diffusion_torch.cli.mol_gen_sample import main as sample_main
    from bio_diffusion_torch.cli.train import main as train_main

    args = list(sys.argv[1:] if argv is None else argv)
    device = next((a.split("=", 1)[1] for a in args if a.startswith("device=")), "cuda")
    if device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("device=cuda but no CUDA device is available (there is no CPU fallback)")
    preset = os.environ.get("POCKET_PRESET", "full")
    if preset not in ("full", "mid", "tiny"):
        raise SystemExit(f"POCKET_PRESET={preset!r}: one of full, mid, tiny")
    tiny = preset == "tiny"
    steps = int(os.environ.get("POCKET_STEPS", 6 if tiny else 2500))
    n_samples = int(os.environ.get("POCKET_SAMPLES", 2 if tiny else 100))
    timesteps = int(os.environ.get("POCKET_TIMESTEPS", 6 if tiny else 250))
    batch = int(os.environ.get("POCKET_BATCH", 8 if tiny else 16))

    overrides = [
        "experiment=pocket_mol_gen_ddpm",
        f"datamodule.dataloader_cfg.batch_size={batch}",
        "model.diffusion_cfg.sample_during_training=false",
        # sampling restores the EMA weights: at the reference decay (0.9999,
        # a 10k-step horizon) a few-thousand-step run's EMA is still mostly
        # the initial weights; a 100-step horizon follows the short run
        "trainer.ema_decay=0.99",
    ] + {"full": [], "mid": MID, "tiny": TINY}[preset]

    workdir = os.environ.get("POCKET_WORKDIR") or tempfile.mkdtemp(prefix="pocket_quality_")
    epochs_needed = max(1, -(-steps * batch // 256) + 1)
    trainer = train_main(overrides + [
        f"--workdir={workdir}", f"--max-steps={steps}", f"--max-epochs={epochs_needed * 4}",
        f"--device={device}", "trainer.early_stopping_patience=999999"])
    losses = [float(r["train/loss"]) for r in trainer.loggers.loggers[0].rows if "train/loss" in r]
    result = {
        "device": torch.cuda.get_device_name(0) if device == "cuda" else device,
        "preset": preset,
        "steps": int(trainer.state.count),
        "final_loss": round(sum(losses[-10:]) / max(1, len(losses[-10:])), 4),
        "first_loss": round(losses[0], 4) if losses else None,
    }
    gt = data_row()
    result["data"] = {k: round(float(gt[k]), 4) for k in KEYS if k in gt}

    sample_common = overrides + ["ddpm_mode=pocket", f"num_samples={n_samples}", f"num_timesteps={timesteps}",
                                 "seed=7", f"device={device}"]
    if tiny:
        sample_common += ["pocket_size=6", "num_nodes=5"]
    for tag, extra in (("trained", [f"ckpt_path={os.path.join(workdir, 'checkpoints')}"]), ("random", [])):
        m = sample_main(sample_common + extra + [f"output_dir={os.path.join(workdir, 'samples_' + tag)}"])
        result[tag] = {k: round(float(m[k]), 4) for k in KEYS if k in m}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
