"""The training loop: epochs, EMA-weight validation, sampling evaluation,
checkpoints, early stopping, batch limits, halt files.

Port of ``bio_diffusion_tpu/train/loop.py::Trainer``.  The model trains on
one device; the EMA twin of the model carries the EMA weights and runs the
validation and the sampling evaluation.  Step metrics stay on the device
until the end of an epoch.  ``init_state`` resumes from the newest
checkpoint under ``<workdir>/<trainer.ckpt_dir>`` (the train state only, not
the data order, as in the JAX package), else warm-starts from
``trainer.warm_start_ckpt``.  A property-conditioned model
(``module_cfg.conditioning``) gets each batch's context from the property
normalizers (mean and MAD of the valid split for ``QM9_second_half``, of the
train split otherwise), and its sampling evaluation draws contexts from the
train split's per-size property histograms.  QM9 and synthetic batches are
padded to the dataset's width, GEOM-Drugs batches each to its bucket
(``bucket_sizes``), as in the JAX package.  Sample renderings (PNG) are
not ported; the sampling evaluation writes xyz files.
"""

from __future__ import annotations

import copy
import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from bio_diffusion_torch.config.build import ExperimentConfig, build_datasets, build_evd, get_dataset_info_for
from bio_diffusion_torch.data.batch import iterate_dense_batches
from bio_diffusion_torch.models.distributions import NumNodesDistribution, property_normalizers
from bio_diffusion_torch.ops.schedules import predefined_gamma_table
from bio_diffusion_torch.train.checkpoints import (
    latest_step,
    reference_state_dict,
    restore_checkpoint,
    save_checkpoint,
    warm_start_params,
)
from bio_diffusion_torch.train.sampling import SegmentedSampler, analyze_samples, sample_molecules
from bio_diffusion_torch.train.state import TrainState
from bio_diffusion_torch.train.step import make_eval_step, make_train_step
from bio_diffusion_torch.train.torch_import import init_random_weights, load_reference_state_dict
from bio_diffusion_torch.utils.logging import MetricLoggers, build_loggers, get_logger

log = get_logger(__name__)

HALT_FILE_EXTENSION = "done"


class Trainer:
    """Single-device trainer of the QM9 and GEOM-Drugs DDPMs with the GCPNet denoiser."""

    def __init__(self, exp: ExperimentConfig, workdir: str, device, datasets: Optional[Dict[str, Any]] = None,
                 loggers: Optional[MetricLoggers] = None):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device=cuda but no CUDA device is available (there is no CPU fallback)")
        tc = exp.trainer
        self.exp, self.workdir, self.device = exp, workdir, device
        os.makedirs(workdir, exist_ok=True)
        self.datasets = datasets if datasets is not None else build_datasets(exp)
        self.dataset_info = get_dataset_info_for(exp)
        hist = {int(k): int(v) for k, v in self.dataset_info["n_nodes"].items()}
        self.nodes_dist = NumNodesDistribution(hist)
        self.conditioning = tuple(exp.module_cfg.conditioning)
        self.props_norms, self.props_distr = property_normalizers(
            self.datasets, self.conditioning, exp.dataloader_cfg.dataset)
        self.evd = build_evd(exp)
        self.evd_ema = None
        self.state: Optional[TrainState] = None
        self.accumulate_grad_batches = max(1, int(tc.accumulate_grad_batches))
        self.train_step = make_train_step(
            self.evd, exp.diffusion_cfg, exp.dataloader_cfg, self.nodes_dist.log_prob_table,
            ema_decay=tc.ema_decay, clip_gradients=exp.module_cfg.clip_gradients,
            accumulate_grad_batches=self.accumulate_grad_batches)
        self.loggers = loggers if loggers is not None else build_loggers(None, workdir)
        self.ckpt_dir = os.path.join(workdir, tc.ckpt_dir)
        self.rng = np.random.default_rng(exp.seed)
        self.generator = torch.Generator(device=device).manual_seed(exp.seed + 1)
        self.start_step = 0  # the optimizer step init_state resumed at
        # optimizer steps, loader batches, validation batches and sampling
        # batches run so far
        self.stats = {"steps": 0, "micro_batches": 0, "eval_batches": 0, "sample_batches": 0}
        self._overfit_cache = None  # the first k train batches for overfit_batches
        self._molecular_metrics = None  # RDKit metrics, built once (False without RDKit)
        self._saved_step = None

    # -- setup ---------------------------------------------------------------

    def _batch_iter(self, split: str, shuffle: bool = True):
        """The split's batches: QM9 and synthetic ones padded to the
        dataset's width, GEOM ones each to its bucket (``bucket_sizes``)."""
        dl = self.exp.dataloader_cfg
        pad_to = None
        if "QM9" in dl.dataset or dl.dataset == "synthetic":
            pad_to = self.datasets[split].data["positions"].shape[1]
        return iterate_dense_batches(
            self.datasets[split], batch_size=dl.batch_size, rng=self.rng,
            shuffle=shuffle and dl.shuffle,
            drop_last=dl.drop_last if split == "train" else False,
            pad_to=pad_to,
            pad_to_multiple=dl.pad_to_multiple, bucket_sizes=dl.bucket_sizes,
            conditioning=self.conditioning, property_norms=self.props_norms)

    def init_state(self, state_dict: Optional[Dict[str, Any]] = None, resume: bool = True) -> TrainState:
        """Weights from ``state_dict`` (reference names, e.g. from
        ``train.torch_import.state_dict_from_jax_params``) or drawn from the
        seed, or warm-started from ``trainer.warm_start_ckpt``; then the EMA
        twin and the optimizer state on the device; then, with ``resume``,
        the newest checkpoint's train state, exactly."""
        tc = self.exp.trainer
        if state_dict is not None:
            load_reference_state_dict(self.evd, state_dict)
        else:
            init_random_weights(self.evd, self.exp.seed)
        resuming = resume and latest_step(self.ckpt_dir) is not None
        if not resuming and tc.warm_start_ckpt:
            # partial (strict=False) warm start: pretrain -> finetune flows
            merged, n_loaded, skipped = warm_start_params(
                tc.warm_start_ckpt, reference_state_dict(self.evd), source=tc.warm_start_source)
            load_reference_state_dict(self.evd, merged)
            log.info("Warm start from %s: %d tensors loaded, %d kept fresh%s", tc.warm_start_ckpt,
                     n_loaded, len(skipped), f" (e.g. {skipped[:3]})" if skipped else "")
        self.evd.to(self.device).train()
        self.evd_ema = copy.deepcopy(self.evd).eval().requires_grad_(False)
        self.state = TrainState(list(self.evd.parameters()), list(self.evd_ema.parameters()),
                                self.exp.optimizer)
        n_params = sum(p.numel() for p in self.evd.parameters())
        log.info("Initialized model with %s parameters on %s", f"{n_params:,}", self.device)
        if resuming:
            self.start_step = restore_checkpoint(self.ckpt_dir, self.evd, self.evd_ema, self.state)
            self._saved_step = self.start_step
            log.info("Resumed from checkpoint step %d", self.start_step)
        return self.state

    # -- phases ----------------------------------------------------------------

    def _limited(self, iterator, limit: float, split: str = "train"):
        """Yield at most ``limit`` batches: a fraction (< 1.0) of the split's
        batch count, or an absolute count (>= 1, Lightning's int semantics:
        the raw config value's type tells ``1``, one batch, from ``1.0``, the
        whole split).  ``fast_dev_run`` yields one batch."""
        exp = self.exp
        if exp.trainer.fast_dev_run:
            for i, b in enumerate(iterator):
                if i >= 1:
                    break
                yield b
            return
        key = {"train": "limit_train_batches", "valid": "limit_val_batches",
               "test": "limit_test_batches"}[split]
        raw = exp.raw.get("trainer", {}).get(key, limit)
        if isinstance(raw, int) and not isinstance(raw, bool) and raw >= 1:
            cap = int(raw)
        elif limit >= 1.0 and float(limit) == 1.0:
            yield from iterator
            return
        elif limit >= 1.0:
            cap = int(limit)
        else:
            # a fraction of the split's batch count, from the dataset's length
            dl = exp.dataloader_cfg
            m = len(self.datasets[split])
            total = m // dl.batch_size if split == "train" and dl.drop_last else -(-m // dl.batch_size)
            cap = max(1, int(total * limit))
        for i, b in enumerate(iterator):
            if i >= cap:
                break
            yield b

    def _train_batches(self):
        """The epoch's train batches: the same first ``overfit_batches``
        unshuffled batches every epoch, or the shuffled split within
        ``limit_train_batches``."""
        k = self.exp.trainer.overfit_batches
        if k > 0:
            if self._overfit_cache is None:
                it = self._batch_iter("train", shuffle=False)
                self._overfit_cache = [b for _, b in zip(range(k), it)]
            return iter(self._overfit_cache)
        return self._limited(self._batch_iter("train"), self.exp.trainer.limit_train_batches)

    def train_epoch(self, epoch: int, max_steps: Optional[int] = None) -> Dict[str, float]:
        accum = self.accumulate_grad_batches
        metrics_acc: Dict[str, list] = {}
        micro: list = []
        for batch in self._train_batches():
            batch = batch.to(self.device)
            if accum > 1:
                micro.append(batch)
                if len(micro) < accum:
                    continue
                metrics = self.train_step(self.state, micro, self.generator)
                micro = []
            else:
                metrics = self.train_step(self.state, batch, self.generator)
            self.stats["steps"] += 1
            self.stats["micro_batches"] += accum
            for k, v in metrics.items():
                metrics_acc.setdefault(k, []).append(v)
            if max_steps is not None and self.state.count >= max_steps:
                break
        if not metrics_acc:
            log.warning("epoch %d: no optimizer steps ran", epoch)
            return {}
        # one device-to-host read per epoch
        means = torch.stack([torch.stack(vs).float().mean() for vs in metrics_acc.values()]).tolist()
        out = dict(zip(metrics_acc, means))
        if not np.isfinite(out["loss"]):
            raise FloatingPointError(f"Non-finite training loss at epoch {epoch}: {out['loss']}")
        self.loggers.log({f"train/{k}": v for k, v in out.items()}, self.state.count, epoch)
        return out

    def validate(self, epoch: int, split: str = "valid", use_ema: bool = True) -> Dict[str, float]:
        exp = self.exp
        evd = self.evd_ema if use_ema else self.evd
        eval_step = make_eval_step(evd, exp.diffusion_cfg, exp.dataloader_cfg,
                                   self.nodes_dist.log_prob_table)
        generator = torch.Generator(device=self.device).manual_seed(exp.seed + 2)
        limit = exp.trainer.limit_test_batches if split == "test" else exp.trainer.limit_val_batches
        accs: Dict[str, list] = {}
        for batch in self._limited(self._batch_iter(split, shuffle=False), limit, split=split):
            info = eval_step(batch.to(self.device), generator)
            self.stats["eval_batches"] += 1
            for k, v in info.items():
                accs.setdefault(k, []).append(v)
        means = torch.stack([torch.stack(vs).float().mean() for vs in accs.values()]).tolist()
        out = dict(zip(accs, means))
        dc = exp.diffusion_cfg
        table = predefined_gamma_table(dc.noise_schedule, dc.num_timesteps, dc.noise_precision)
        out["log_SNR_max"] = float(-table[0])
        out["log_SNR_min"] = float(-table[-1])
        self.loggers.log({f"{split}/{k}": v for k, v in out.items()}, self.state.count, epoch)
        return out

    def _get_molecular_metrics(self):
        """RDKit validity/uniqueness/novelty metrics (reference analyze_samples,
        qm9_mol_gen_ddpm.py:845-885), built once when RDKit imports, else None."""
        if self._molecular_metrics is None:
            from bio_diffusion_torch.chem.rdkit_bridge import build_molecular_metrics

            self._molecular_metrics = build_molecular_metrics(
                self.dataset_info, self.exp.dataloader_cfg.smiles_filepath) or False
        return self._molecular_metrics or None

    def evaluate_sampling(self, epoch: int, num_samples: Optional[int] = None) -> Dict[str, float]:
        """Sample ``num_eval_samples`` molecules from the EMA weights in
        ``eval_batch_size`` batches, log their stability and atom-type KL
        under ``val/``, and every ``visualize_sample_epochs`` epochs write the
        first ``num_visualization_samples`` as xyz files under
        ``<workdir>/media/epoch_<epoch>``, with a PNG each where matplotlib
        is installed."""
        exp = self.exp
        dc = exp.diffusion_cfg
        num_samples = num_samples or dc.num_eval_samples
        generator = torch.Generator(device=self.device).manual_seed(exp.seed + 3 + epoch)
        sampler = SegmentedSampler(self.evd_ema, self.device)
        xh, node_mask, _ = sample_molecules(sampler, generator, num_samples, self.nodes_dist, self.rng,
                                            batch_size=dc.eval_batch_size, props_distr=self.props_distr)
        self.stats["sample_batches"] += sampler.runs
        metrics = analyze_samples(xh, node_mask, self.dataset_info,
                                  include_charges=exp.dataloader_cfg.include_charges,
                                  molecular_metrics=self._get_molecular_metrics())
        self.loggers.log({f"val/{k}": v for k, v in metrics.items()}, self.state.count, epoch)
        log.info("Sampling eval @epoch %d: %s", epoch, metrics)
        viz_every = dc.visualize_sample_epochs
        if viz_every and epoch % viz_every == 0:
            from bio_diffusion_torch.chem.molecule import save_xyz_files
            from bio_diffusion_torch.chem.visualization import can_render, visualize_mols

            n_viz = min(dc.num_visualization_samples, len(xh))
            k = len(self.dataset_info["atom_decoder"])
            media_dir = os.path.join(self.workdir, "media", f"epoch_{epoch}")
            save_xyz_files(media_dir, xh[:n_viz, :, :3], xh[:n_viz, :, 3:3 + k], node_mask[:n_viz],
                           self.dataset_info)
            if can_render():
                try:
                    visualize_mols(media_dir, self.dataset_info, max_num=n_viz)
                except Exception as e:  # noqa: BLE001 — renderings are best-effort, as in the JAX Trainer
                    log.warning("sample visualization failed: %s", e)
        return metrics

    # -- fit --------------------------------------------------------------------

    def save(self) -> None:
        """A checkpoint of the current step, unless one was written at it."""
        if self._saved_step != self.state.count:
            save_checkpoint(self.ckpt_dir, self.evd, self.evd_ema, self.state)
            self._saved_step = self.state.count

    def fit(self, max_epochs: Optional[int] = None, max_steps: Optional[int] = None) -> TrainState:
        exp, tc = self.exp, self.exp.trainer
        max_epochs = max_epochs if max_epochs is not None else tc.max_epochs
        if tc.fast_dev_run:
            # reference trainer.fast_dev_run: 1 train + 1 val batch, one
            # epoch, no checkpoints (configs/debug/fdr.yaml)
            if self.state is None:
                self.init_state(resume=False)
            m = self.train_epoch(0)
            v = self.validate(0)
            log.info("fast_dev_run: train=%.4f val=%.4f", m.get("loss", float("nan")), v["loss"])
            return self.state
        if self.state is None:
            self.init_state()

        # early stopping (reference configs/callbacks/early_stopping.yaml)
        monitor = tc.early_stopping_monitor
        mode_sign = -1.0 if tc.early_stopping_mode == "max" else 1.0
        best_monitor = float("inf")
        bad_checks = 0

        for epoch in range(max_epochs):
            t0 = time.time()
            train_metrics = self.train_epoch(epoch, max_steps=max_steps)
            log.info("epoch %d: loss=%.4f (%.1fs)", epoch, train_metrics.get("loss", float("nan")),
                     time.time() - t0)
            if (epoch + 1) % tc.check_val_every_n_epoch == 0:
                val_metrics = self.validate(epoch)
                log.info("epoch %d: val/loss=%.4f (EMA weights)", epoch, val_metrics["loss"])
                dc = exp.diffusion_cfg
                if dc.sample_during_training and (epoch + 1) % dc.eval_epochs == 0:
                    self.evaluate_sampling(epoch)
                if monitor:
                    # the monitor names the logged metric ("val/loss" is
                    # validate()'s "loss"); min_epochs gates stopping
                    value = val_metrics.get(monitor.split("/", 1)[-1])
                    if value is None:
                        log.warning("early stopping: metric %r not found", monitor)
                    elif tc.early_stopping_check_finite and not np.isfinite(value):
                        log.error("early stopping: %s=%s is not finite", monitor, value)
                        break
                    elif mode_sign * value < best_monitor - tc.early_stopping_min_delta:
                        best_monitor, bad_checks = mode_sign * value, 0
                    else:
                        bad_checks += 1
                        if bad_checks >= tc.early_stopping_patience and epoch + 1 >= tc.min_epochs:
                            log.info("early stopping at epoch %d: %s did not improve for %d checks",
                                     epoch, monitor, bad_checks)
                            break
            if (epoch + 1) % tc.ckpt_every_n_epochs == 0:
                self.save()
            if max_steps is not None and self.state.count >= max_steps:
                break

        self.save()
        self._write_halt_file()
        return self.state

    def _write_halt_file(self) -> None:
        """Grid-search completion signal (reference on_fit_end,
        qm9_mol_gen_ddpm.py:1306-1321)."""
        grid_dir = (self.exp.raw.get("paths") or {}).get("grid_search_script_dir")
        if grid_dir:
            os.makedirs(grid_dir, exist_ok=True)
            run_id = self.exp.raw.get("task_name", "run")
            with open(os.path.join(grid_dir, f"{run_id}.{HALT_FILE_EXTENSION}"), "w") as f:
                f.write("`on_fit_end` has been called.")
