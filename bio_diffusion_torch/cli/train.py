"""Training entry point (PyTorch): ``bio_diffusion_torch.train.loop.Trainer``.

Port of ``bio_diffusion_tpu/cli/train.py``.  Composes ``configs/train.yaml``
with the port's config loader (a copy of the JAX package's) and trains
on one device, or data-parallel with one process a card under ``torchrun``.

Usage:
  python -m bio_diffusion_torch.cli.train experiment=qm9_mol_gen_ddpm|geom_mol_gen_ddpm \\
      [datamodule.dataloader_cfg.dataset=QM9|QM9_first_half|QM9_second_half|synthetic] \\
      [datamodule.dataloader_cfg.data_dir=DIR] [k=v ...] \\
      [--max-steps=K] [--max-epochs=E] [--workdir=DIR] [--device=cuda|cpu] \\
      [trainer.detect_anomaly=true] [trainer.profile=true] [--profile=DIR] [--dump-graph]
  torchrun --nproc_per_node=K -m bio_diffusion_torch.cli.train ... [--dist-init=URL] [--dist-timeout=S]

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

``trainer.detect_anomaly=true`` (or ``debug=default``) checks the loss's
invariants every step (``utils/debug.py``): masked inputs, CoM-free
positions, a masked and finite denoiser output; a failed check raises after
its step.  ``--profile=DIR`` (``trainer.profile=true``: ``<workdir>/profile``)
traces ``fit`` with ``torch.profiler`` into ``DIR/trace.json``;
``--dump-graph`` writes the denoiser's module tree and the op sequence of
one call at B=2 and the dataset's largest N to
``<workdir>/graph/dynamics.{modules,ops}.txt``.  The seconds ``fit`` took go
to ``<workdir>/exec_time.log``.

Data parallelism: launched by ``torchrun`` (``WORLD_SIZE`` set) with
``trainer.use_mesh=true`` (the default), each process joins the group
(``parallel.distributed.init_distributed``: NCCL with rank r on
``cuda:LOCAL_RANK``, one rank a card, else an error; gloo with
``--device=cpu``) and trains its rows of every global batch
(``train/loop.py``); rank 0 writes the checkpoints, metrics, profile and
graph files.  ``trainer.multihost=true`` joins a group from JAX's
``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES`` / ``JAX_PROCESS_ID``
where torchrun's variables are absent.  ``--dist-init=URL`` gives the
rendezvous (e.g. ``file:///path``) in place of ``MASTER_ADDR`` /
``MASTER_PORT``; ``--dist-timeout=S`` bounds every wait in a collective
(default 7200 s: the ranks wait while rank 0 runs the sampling
evaluation).  ``trainer.use_mesh=false`` under ``WORLD_SIZE > 1`` and
``trainer.num_model_shards > 1`` (parameter sharding, not ported) raise.
Without a launcher, training runs on ``--device`` alone.
"""

from __future__ import annotations

import logging
import os
import sys
import time

import torch

from bio_diffusion_torch.cli.common import parse_cli
from bio_diffusion_torch.config.build import build_experiment
from bio_diffusion_torch.parallel.distributed import (
    DEFAULT_TIMEOUT_S,
    check_model_shards,
    init_distributed,
    launched_world,
    shutdown,
)
from bio_diffusion_torch.train.loop import Trainer
from bio_diffusion_torch.utils.logging import MetricLoggers, build_loggers, get_logger
from bio_diffusion_torch.utils.profiling import dump_computation_graph, profile_trace

log = get_logger(__name__)


def main(argv=None) -> Trainer:
    cfg, flags = parse_cli(list(sys.argv[1:] if argv is None else argv), "train", __doc__)
    unknown = set(flags) - {"max-steps", "max-epochs", "workdir", "device", "config-dir", "config-name",
                            "profile", "dump-graph", "dist-init", "dist-timeout"}
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
    check_model_shards(exp.trainer.num_model_shards)
    dp = None
    world = launched_world()
    if world is not None or exp.trainer.multihost:
        if exp.trainer.use_mesh:
            dp = init_distributed(torch.device(device).type, init_method=flags.get("dist-init"),
                                  timeout_s=float(flags.get("dist-timeout") or DEFAULT_TIMEOUT_S))
            device = dp.device
            log.info("Data parallel: rank %d of %d on %s (%s)", dp.rank, dp.world, device, dp.backend)
        elif (world or 1) > 1:
            raise ValueError(f"launched with WORLD_SIZE={world} but trainer.use_mesh=false: set "
                             "trainer.use_mesh=true for data parallelism, or launch one process")
    main_rank = dp is None or dp.is_main
    loggers = build_loggers(cfg.get("logger"), workdir) if main_rank else MetricLoggers()
    try:
        trainer = Trainer(exp, workdir, device, loggers=loggers, dp=dp)
        if "dump-graph" in flags:
            if trainer.state is None:  # a collective under data parallelism: every rank
                trainer.init_state(resume=not exp.trainer.fast_dev_run)
            if main_rank:
                log.info("Wrote computation graphs: %s", dump_denoiser_graph(trainer))
        profile_dir = flags.get("profile") or (os.path.join(workdir, "profile") if exp.trainer.profile else None)
        t_start = time.time()
        with profile_trace(profile_dir if main_rank else None):
            trainer.fit(max_epochs=int(flags["max-epochs"]) if flags.get("max-epochs") else None,
                        max_steps=int(flags["max-steps"]) if flags.get("max-steps") else None)
        if main_rank:
            with open(os.path.join(workdir, "exec_time.log"), "w") as f:
                f.write(f"{time.time() - t_start:.2f}s\n")
        if cfg.get("test"):
            log.info("test metrics: %s", trainer.validate(epoch=-1, split="test"))
    finally:
        if dp is not None:
            shutdown()
    return trainer


def dump_denoiser_graph(trainer: Trainer):
    """The denoiser's graph files (``utils/profiling.dump_computation_graph``)
    for one call on zeros at B=2 and the dataset's largest N, under
    ``<workdir>/graph``.  The weights are initialized first as ``fit``
    would (a fast_dev_run resumes from no checkpoint), so the dump does
    not change what is trained."""
    if trainer.state is None:
        trainer.init_state(resume=not trainer.exp.trainer.fast_dev_run)
    b, n = 2, int(trainer.dataset_info["max_n_nodes"])
    nf = trainer.evd.num_x_dims + trainer.evd.num_node_scalar_features
    f32 = dict(dtype=torch.float32, device=trainer.device)
    context = torch.zeros((b, n, len(trainer.conditioning)), **f32) if trainer.conditioning else None
    args = (torch.zeros((b, n, nf), **f32), torch.zeros((b, 1), **f32), torch.ones((b, n), **f32), context)
    return dump_computation_graph(trainer.evd.dynamics_network, args, os.path.join(trainer.workdir, "graph"),
                                  name="dynamics")


if __name__ == "__main__":
    main()
