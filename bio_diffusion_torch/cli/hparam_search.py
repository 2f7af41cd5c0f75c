"""Hyperparameter search (counterpart of ``scripts/hparam_search.py``
and of the reference's Optuna sweeper, configs/hparams_search/qm9_optuna.yaml
+ ``python train.py -m hparams_search=...``).

Runs n_trials training runs of ``bio_diffusion_torch.cli.train.main``, in
this process, each with sampled overrides, optimizing a metric read from
each run's metrics.csv.  The study persists to <out_dir>/study.json in the
JAX package's format, so an interrupted search (of either package) resumes.
A trial that raises scores worst and the search goes on.

Usage:
  python -m bio_diffusion_torch.cli.hparam_search space.json out_dir/ \\
      [--n-trials 20] [--metric val/loss] [--direction minimize] \\
      [--sampler tpe|random] [--startup-trials 10] [--reduce last|min] \\
      [--max-epochs N] [--max-steps K] [--device cuda|cpu] \\
      [-- extra train-CLI overrides...]

space.json example (reference Optuna params syntax):
  {"model.optimizer.lr": "interval(1e-5, 1e-2, log)",
   "datamodule.dataloader_cfg.batch_size": "choice(32, 64, 128)",
   "model.model_cfg.num_encoder_layers": "int_interval(2, 9)"}

``--device`` (default ``cuda``) goes to every trial's ``cli.train``.
"""

from __future__ import annotations

import json
import os
import sys

from bio_diffusion_torch.utils.hparam import Study, read_metric_from_csv


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    extra = []
    if "--" in argv:
        i = argv.index("--")
        argv, extra = argv[:i], argv[i + 1:]
    if len(argv) < 2:
        print(__doc__)
        sys.exit(1)
    space_path, out_dir = argv[0], argv[1]

    def opt(flag, default):
        if flag in argv:
            return argv[argv.index(flag) + 1]
        return default

    n_trials = int(opt("--n-trials", 20))
    metric = opt("--metric", "val/loss")
    direction = opt("--direction", "minimize")
    sampler = opt("--sampler", "tpe")
    startup = int(opt("--startup-trials", 10))
    reduce = opt("--reduce", "last")
    max_epochs = opt("--max-epochs", None)
    max_steps = opt("--max-steps", None)
    device = opt("--device", "cuda")

    with open(space_path) as f:
        space = json.load(f)

    os.makedirs(out_dir, exist_ok=True)
    study = Study(space, direction=direction, sampler=sampler, n_startup_trials=startup,
                  path=os.path.join(out_dir, "study.json"))

    from bio_diffusion_torch.cli.train import main as train_main

    start = len([t for t in study.trials if t.get("value") is not None])
    for i in range(start, n_trials):
        params = study.suggest()
        run_dir = os.path.join(out_dir, f"trial_{i:04d}")
        args = [f"{k}={v}" for k, v in params.items()] + list(extra)
        args += [f"--workdir={run_dir}", f"--device={device}"]
        if max_epochs is not None:
            args.append(f"--max-epochs={max_epochs}")
        if max_steps is not None:
            args.append(f"--max-steps={max_steps}")
        print(f"[trial {i}] {params}")
        try:
            train_main(args)
            value = read_metric_from_csv(os.path.join(run_dir, "metrics.csv"), metric, reduce=reduce)
        except Exception as e:  # noqa: BLE001 - a failed trial scores worst, the search goes on
            print(f"[trial {i}] FAILED: {e}")
            value = float("inf") if direction == "minimize" else float("-inf")
        study.record(params, value)
        print(f"[trial {i}] {metric}={value}")

    best = study.best_trial()
    print(f"best trial: {json.dumps(best, indent=2)}")
    with open(os.path.join(out_dir, "best_trial.json"), "w") as f:
        json.dump(best, f, indent=2)
    return study


if __name__ == "__main__":
    main()
