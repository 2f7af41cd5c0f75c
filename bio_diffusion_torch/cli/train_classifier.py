"""Property-classifier training entry point (PyTorch).

Port of ``bio_diffusion_tpu/cli/train_classifier.py``.  Trains the
``EGNNClassifier`` on one QM9 property and writes it in the
``classifier.npz`` / ``classifier.json`` layout that both packages'
conditional evaluation CLIs accept as ``classifier_model_dir``, with the
per-epoch history in ``history.json`` beside it.  ``dataset=QM9`` becomes
``QM9_first_half``: the classifier learns on the half of the seed-42
re-split that the conditional generator never sees.

Usage:
  python -m bio_diffusion_torch.cli.train_classifier property=alpha \\
      [epochs=100] [hidden_nf=128] [n_layers=7] [batch_size=96] [lr=1e-3] \\
      [device=cuda|cpu] [output_dir=DIR] [k=v ...]

The classifier goes to ``<output_dir>/<property>``.  ``device`` defaults to
``cuda``; there is no fallback to the CPU.
"""

from __future__ import annotations

import json
import os
import sys

from bio_diffusion_torch.cli.common import device_of, parse_cli
from bio_diffusion_torch.config.build import build_datasets, build_experiment
from bio_diffusion_torch.config.schema import compute_num_atom_types
from bio_diffusion_torch.train.classifier_train import save_jax_classifier, train_property_classifier
from bio_diffusion_torch.utils.logging import get_logger

log = get_logger(__name__)


def main(argv=None):
    cfg, _ = parse_cli(list(sys.argv[1:] if argv is None else argv), "train_classifier", __doc__)
    prop = str(cfg.get("property", "alpha"))
    dm = cfg.setdefault("datamodule", {}).setdefault("dataloader_cfg", {})
    if str(dm.get("dataset", "QM9")) == "QM9":
        dm["dataset"] = "QM9_first_half"
    exp = build_experiment(cfg)
    device = device_of(cfg)
    classifier, norms, history = train_property_classifier(
        build_datasets(exp), prop, num_atom_types=compute_num_atom_types(exp.dataloader_cfg),
        hidden_nf=int(cfg.get("hidden_nf", 128)), n_layers=int(cfg.get("n_layers", 7)),
        attention=bool(cfg.get("attention", True)), epochs=int(cfg.get("epochs", 100)),
        batch_size=int(cfg.get("batch_size", 96)), lr=float(cfg.get("lr", 1e-3)),
        weight_decay=float(cfg.get("weight_decay", 1e-16)), seed=int(cfg.get("seed", 0)), device=device)

    out_dir = os.path.join(str(cfg.get("output_dir", "outputs/train_classifier")), prop)
    save_jax_classifier(out_dir, classifier, norms, prop, extra={"dataset": exp.dataloader_cfg.dataset})
    with open(os.path.join(out_dir, "history.json"), "w") as f:
        json.dump(history, f, indent=2)
    result = {"property": prop, "model_dir": out_dir, "best_valid_mae": history.get("best_valid_mae")}
    log.info("Classifier saved: %s", result)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
