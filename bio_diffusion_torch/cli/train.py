"""Training entry point (PyTorch): ``bio_diffusion_torch.train.loop.Trainer``.

Port of ``bio_diffusion_tpu/cli/train.py``.  Composes ``configs/train.yaml``
with the port's config loader (a copy of the JAX package's) and trains
on one device.

Usage:
  python -m bio_diffusion_torch.cli.train experiment=qm9_mol_gen_ddpm|geom_mol_gen_ddpm \\
      [datamodule.dataloader_cfg.dataset=QM9|QM9_first_half|QM9_second_half|synthetic] \\
      [datamodule.dataloader_cfg.data_dir=DIR] [k=v ...] \\
      [--max-steps=K] [--max-epochs=E] [--workdir=DIR] [--device=cuda|cpu]

QM9 is read from ``<data_dir>/QM9``: the processed ``train/valid/test.npz``
or the GDB9 tarball with ``uncharacterized.txt`` and ``atomref.txt``;
GEOM-Drugs from ``<data_dir>/GEOM/GEOM_drugs_30.npy`` (made by
``data.geom.extract_conformers``), each batch padded to its bucket;
nothing is downloaded.  ``--device`` defaults to ``cuda``; there is no
fallback to the CPU.  Checkpoints go to ``<workdir>/<trainer.ckpt_dir>``
(``step_<n>.pt``); a second run on the same workdir resumes from the newest
(the train state, not the data order), and ``trainer.warm_start_ckpt=PATH``
(with ``trainer.warm_start_source=params|ema_params``) warm-starts a fresh
run.  Metrics go to ``<workdir>/metrics.csv`` (and the ``logger`` group's
other backends).  ``test=true`` evaluates the test split after training.
"""

from __future__ import annotations

import logging
import sys

from bio_diffusion_torch.cli.common import parse_cli
from bio_diffusion_torch.config.build import build_experiment
from bio_diffusion_torch.train.loop import Trainer
from bio_diffusion_torch.utils.logging import build_loggers, get_logger

log = get_logger(__name__)


def main(argv=None) -> Trainer:
    cfg, flags = parse_cli(list(sys.argv[1:] if argv is None else argv), "train", __doc__)
    unknown = set(flags) - {"max-steps", "max-epochs", "workdir", "device", "config-dir", "config-name"}
    if unknown:
        raise SystemExit(f"unknown flags: {sorted(unknown)}")
    if not logging.getLogger().handlers:
        logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")

    exp = build_experiment(cfg)
    workdir = flags.get("workdir") or "outputs/train_torch"
    device = flags.get("device") or "cuda"
    log.info("Experiment: dataset=%s, layers=%d, precision=%s, device=%s, workdir=%s",
             exp.dataloader_cfg.dataset, exp.model_cfg.num_encoder_layers, exp.trainer.precision,
             device, workdir)
    trainer = Trainer(exp, workdir, device, loggers=build_loggers(cfg.get("logger"), workdir))
    trainer.fit(max_epochs=int(flags["max-epochs"]) if flags.get("max-epochs") else None,
                max_steps=int(flags["max-steps"]) if flags.get("max-steps") else None)
    if cfg.get("test"):
        log.info("test metrics: %s", trainer.validate(epoch=-1, split="test"))
    return trainer


if __name__ == "__main__":
    main()
