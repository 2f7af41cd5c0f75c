"""Training entry point (PyTorch): ``bio_diffusion_torch.train.loop.Trainer``.

Port of ``bio_diffusion_tpu/cli/train.py``.  Composes ``configs/train.yaml``
with the port's config loader (a copy of the JAX package's) and trains
on one device.

Usage:
  python -m bio_diffusion_torch.cli.train experiment=qm9_mol_gen_ddpm \\
      datamodule.dataloader_cfg.dataset=synthetic [k=v ...] \\
      [--max-steps=K] [--max-epochs=E] [--workdir=DIR] [--device=cuda|cpu]

``--device`` defaults to ``cuda``; there is no fallback to the CPU.  Only
the synthetic QM9-schema dataset is ported so far.  Metrics go to
``<workdir>/metrics.csv``.
"""

from __future__ import annotations

import logging
import sys

from bio_diffusion_torch.config.build import build_experiment
from bio_diffusion_torch.config.loader import default_config_dir, load_config
from bio_diffusion_torch.train.loop import Trainer

log = logging.getLogger(__name__)


def main(argv=None) -> Trainer:
    argv = list(sys.argv[1:] if argv is None else argv)
    overrides, flags = [], {}
    for arg in argv:
        if arg.startswith("--"):
            k, _, v = arg[2:].partition("=")
            flags[k] = v
        else:
            overrides.append(arg)
    if "help" in flags:
        print(__doc__.strip())
        raise SystemExit(0)
    unknown = set(flags) - {"max-steps", "max-epochs", "workdir", "device"}
    if unknown:
        raise SystemExit(f"unknown flags: {sorted(unknown)}")
    if not logging.getLogger().handlers:
        logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")

    cfg = load_config(default_config_dir(), "train", overrides)
    exp = build_experiment(cfg)
    workdir = flags.get("workdir") or "outputs/train_torch"
    device = flags.get("device") or "cuda"
    log.info("Experiment: dataset=%s, layers=%d, precision=%s, device=%s, workdir=%s",
             exp.dataloader_cfg.dataset, exp.model_cfg.num_encoder_layers, exp.trainer.precision,
             device, workdir)
    trainer = Trainer(exp, workdir, device)
    trainer.fit(max_epochs=int(flags["max-epochs"]) if flags.get("max-epochs") else None,
                max_steps=int(flags["max-steps"]) if flags.get("max-steps") else None)
    return trainer


if __name__ == "__main__":
    main()
