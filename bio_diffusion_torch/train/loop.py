"""The training loop: epochs, EMA-weight validation, CSV metrics.

Port of ``bio_diffusion_tpu/train/loop.py::Trainer`` (``_batch_iter``,
``init_state``, ``train_epoch``, ``validate``, ``fit``) and of the synthetic
branch of ``config/build.py::build_datasets``.  The model trains on one
device; the EMA twin of the model carries the EMA weights and runs the
validation.  Step metrics stay on the device until the end of an epoch.
Checkpoints, sampling evaluation, early stopping, batch limits and halt files
are not ported yet.
"""

from __future__ import annotations

import copy
import csv
import logging
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from bio_diffusion_torch.config.build import ExperimentConfig
from bio_diffusion_torch.data.batch import iterate_dense_batches
from bio_diffusion_torch.data.dataset_info import get_dataset_info
from bio_diffusion_torch.models.diffusion import EquivariantVariationalDiffusion
from bio_diffusion_torch.models.distributions import NumNodesDistribution
from bio_diffusion_torch.models.gcpnet import GCPNetDynamics
from bio_diffusion_torch.ops.schedules import predefined_gamma_table
from bio_diffusion_torch.train.state import TrainState
from bio_diffusion_torch.train.step import make_eval_step, make_train_step
from bio_diffusion_torch.train.torch_import import init_random_weights, load_reference_state_dict

log = logging.getLogger(__name__)


def build_datasets(exp: ExperimentConfig) -> Dict[str, Any]:
    """Train/valid/test ``DenseDataset``s of the configured dataset."""
    dl = exp.dataloader_cfg
    if dl.dataset == "synthetic":
        from bio_diffusion_torch.data.synthetic import synthetic_qm9_like

        return {
            "train": synthetic_qm9_like(512, seed=exp.seed),
            "valid": synthetic_qm9_like(128, seed=exp.seed + 1),
            "test": synthetic_qm9_like(128, seed=exp.seed + 2),
        }
    raise NotImplementedError(f"dataset {dl.dataset!r} is not ported yet (synthetic only)")


class CSVLogger:
    """Metrics log: one row per call, a column per metric name seen so far."""

    def __init__(self, path: str):
        self.path = path
        self.columns: List[str] = ["step", "epoch", "time"]
        self.rows: List[Dict[str, Any]] = []

    def log(self, metrics: Dict[str, float], step: int, epoch: Optional[int] = None) -> None:
        self.rows.append({"step": step, "epoch": epoch, "time": time.time(), **metrics})
        self.columns += [k for k in metrics if k not in self.columns]
        with open(self.path, "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=self.columns)
            writer.writeheader()
            writer.writerows(self.rows)


class Trainer:
    """Single-device trainer of the QM9 DDPM with the GCPNet denoiser."""

    def __init__(self, exp: ExperimentConfig, workdir: str, device, datasets: Optional[Dict[str, Any]] = None):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device=cuda but no CUDA device is available (there is no CPU fallback)")
        tc = exp.trainer
        if (tc.fast_dev_run or tc.overfit_batches
                or (tc.limit_train_batches, tc.limit_val_batches, tc.limit_test_batches) != (1.0, 1.0, 1.0)):
            raise NotImplementedError("fast_dev_run, overfit_batches and batch limits are not ported yet")
        if exp.diffusion_cfg.dynamics_network != "gcpnet" or exp.module_cfg.conditioning:
            raise NotImplementedError("the port trains the unconditional GCPNet DDPM only")
        self.exp, self.workdir, self.device = exp, workdir, device
        os.makedirs(workdir, exist_ok=True)
        self.datasets = datasets if datasets is not None else build_datasets(exp)
        self.dataset_info = get_dataset_info("QM9", exp.dataloader_cfg.remove_h)
        hist = {int(k): int(v) for k, v in self.dataset_info["n_nodes"].items()}
        self.nodes_dist = NumNodesDistribution(hist)
        compute_dtype = "bfloat16" if tc.precision in ("bf16", "bfloat16") else None
        self.evd = EquivariantVariationalDiffusion(
            GCPNetDynamics(exp.model_cfg, exp.module_cfg, exp.layer_cfg, exp.diffusion_cfg,
                           exp.dataloader_cfg, compute_dtype=compute_dtype),
            exp.diffusion_cfg, exp.dataloader_cfg)
        self.evd_ema: Optional[EquivariantVariationalDiffusion] = None
        self.state: Optional[TrainState] = None
        self.accumulate_grad_batches = max(1, int(tc.accumulate_grad_batches))
        self.train_step = make_train_step(
            self.evd, exp.diffusion_cfg, exp.dataloader_cfg, self.nodes_dist.log_prob_table,
            ema_decay=tc.ema_decay, clip_gradients=exp.module_cfg.clip_gradients,
            accumulate_grad_batches=self.accumulate_grad_batches)
        self.logger = CSVLogger(os.path.join(workdir, "metrics.csv"))
        self.rng = np.random.default_rng(exp.seed)
        self.generator = torch.Generator(device=device).manual_seed(exp.seed + 1)
        # optimizer steps, loader batches and validation batches run so far
        self.stats = {"steps": 0, "micro_batches": 0, "eval_batches": 0}

    # -- setup ---------------------------------------------------------------

    def _batch_iter(self, split: str, shuffle: bool = True):
        dl = self.exp.dataloader_cfg
        return iterate_dense_batches(
            self.datasets[split], batch_size=dl.batch_size, rng=self.rng,
            shuffle=shuffle and dl.shuffle,
            drop_last=dl.drop_last if split == "train" else False,
            pad_to=self.datasets[split].data["positions"].shape[1],
            pad_to_multiple=dl.pad_to_multiple, bucket_sizes=dl.bucket_sizes)

    def init_state(self, state_dict: Optional[Dict[str, Any]] = None) -> TrainState:
        """Weights from ``state_dict`` (reference names, e.g. from
        ``train.torch_import.state_dict_from_jax_params``) or drawn from the
        seed; then the EMA twin and the optimizer state on the device."""
        if state_dict is not None:
            load_reference_state_dict(self.evd, state_dict)
        else:
            init_random_weights(self.evd, self.exp.seed)
        self.evd.to(self.device).train()
        self.evd_ema = copy.deepcopy(self.evd).eval().requires_grad_(False)
        self.state = TrainState(list(self.evd.parameters()), list(self.evd_ema.parameters()),
                                self.exp.optimizer)
        n_params = sum(p.numel() for p in self.evd.parameters())
        log.info("Initialized model with %s parameters on %s", f"{n_params:,}", self.device)
        return self.state

    # -- phases ----------------------------------------------------------------

    def train_epoch(self, epoch: int, max_steps: Optional[int] = None) -> Dict[str, float]:
        accum = self.accumulate_grad_batches
        metrics_acc: Dict[str, list] = {}
        micro: list = []
        for batch in self._batch_iter("train"):
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
        self.logger.log({f"train/{k}": v for k, v in out.items()}, self.state.count, epoch)
        return out

    def validate(self, epoch: int, split: str = "valid", use_ema: bool = True) -> Dict[str, float]:
        exp = self.exp
        evd = self.evd_ema if use_ema else self.evd
        eval_step = make_eval_step(evd, exp.diffusion_cfg, exp.dataloader_cfg,
                                   self.nodes_dist.log_prob_table)
        generator = torch.Generator(device=self.device).manual_seed(exp.seed + 2)
        accs: Dict[str, list] = {}
        for batch in self._batch_iter(split, shuffle=False):
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
        self.logger.log({f"{split}/{k}": v for k, v in out.items()}, self.state.count, epoch)
        return out

    def fit(self, max_epochs: Optional[int] = None, max_steps: Optional[int] = None) -> TrainState:
        exp = self.exp
        max_epochs = max_epochs if max_epochs is not None else exp.trainer.max_epochs
        if self.state is None:
            self.init_state()
        for epoch in range(max_epochs):
            t0 = time.time()
            train_metrics = self.train_epoch(epoch, max_steps=max_steps)
            log.info("epoch %d: loss=%.4f (%.1fs)", epoch, train_metrics.get("loss", float("nan")),
                     time.time() - t0)
            if (epoch + 1) % exp.trainer.check_val_every_n_epoch == 0:
                val = self.validate(epoch)
                log.info("epoch %d: val/loss=%.4f (EMA weights)", epoch, val["loss"])
            if max_steps is not None and self.state.count >= max_steps:
                break
        return self.state
