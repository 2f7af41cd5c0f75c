"""Train and eval steps: loss -> grad -> clip -> AMSGrad -> EMA.

Port of ``bio_diffusion_tpu/train/step.py``.  A step runs on the device end
to end and returns its metrics as device tensors: nothing is read back to
the host per step.  Draws come from a ``torch.Generator`` unless given as
tensors (``draws``: ``t_int [B, 1]``, ``eps_t`` and, for evaluation, ``eps_0``),
which is how the tests feed in the JAX package's draws.

With ``diffusion_cfg.debug_invariants`` (``trainer.detect_anomaly`` or
``debug=default``) the loss's invariant checks (``utils/debug.py``) are
recorded on the device over the whole step, every micro-batch included,
and read back once after it: a failed check raises ``InvariantError``.
Off, the steps run no check and read nothing back.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from bio_diffusion_torch.config.schema import DataloaderConfig, DiffusionConfig, compute_num_atom_types
from bio_diffusion_torch.data.batch import DenseMolBatch
from bio_diffusion_torch.models.diffusion import assemble_nll
from bio_diffusion_torch.ops.geometry import centralize
from bio_diffusion_torch.train.state import TrainState, adaptive_clip
from bio_diffusion_torch.utils.debug import checked_call

Tensor = torch.Tensor
Draws = Optional[Dict[str, Tensor]]


def make_loss_fn(evd, diffusion_cfg: DiffusionConfig, dataloader_cfg: DataloaderConfig,
                 log_pN_table: np.ndarray, training: bool) -> Callable:
    """``loss_fn(batch, generator, draws=None) -> (mean nll, info)`` for a
    batch of torch tensors on the model's device; a conditioned model reads
    the batch's context."""
    nsf = compute_num_atom_types(dataloader_cfg) + int(dataloader_cfg.include_charges)
    tables: Dict[torch.device, Tensor] = {}

    def loss_fn(batch: DenseMolBatch, generator: Optional[torch.Generator], draws: Draws = None):
        dev = batch.x.device
        if dev not in tables:
            tables[dev] = torch.as_tensor(log_pN_table, dtype=torch.float32, device=dev)
        table = tables[dev]
        _, x = centralize(batch.x, batch.node_mask)
        terms = evd.loss_terms(x, batch.one_hot, batch.charges, batch.node_mask, training,
                               generator=generator, context=batch.context, **(draws or {}))
        num_nodes = batch.node_mask.sum(dim=-1).long()
        log_pN = table[torch.clamp(num_nodes, 0, table.shape[0] - 1)]
        nll, info = assemble_nll(
            terms, loss_type=diffusion_cfg.loss_type, training=training,
            T=diffusion_cfg.num_timesteps, num_x_dims=dataloader_cfg.num_x_dims,
            num_node_scalar_features=nsf, log_pN=log_pN,
            norm_training_by_max_nodes=diffusion_cfg.norm_training_by_max_nodes)
        return nll.mean(), info

    return loss_fn


def make_train_step(evd, diffusion_cfg: DiffusionConfig, dataloader_cfg: DataloaderConfig,
                    log_pN_table: np.ndarray, ema_decay: float = 0.9999,
                    clip_gradients: bool = True, accumulate_grad_batches: int = 1) -> Callable:
    """``train_step(state, batch, generator, draws=None) -> metrics``.

    Updates ``state`` (and so the model's parameters and the EMA) in place.
    With ``accumulate_grad_batches = k > 1`` the step takes a sequence of k
    micro-batches (and k draws): gradients are averaged over them and applied
    in one clipped update, the mean-loss big-batch step."""
    loss_fn = make_loss_fn(evd, diffusion_cfg, dataloader_cfg, log_pN_table, training=True)
    k = max(1, int(accumulate_grad_batches))

    def grads_of(state: TrainState, batch, generator, draws) -> Tuple[Sequence[Tensor], Dict]:
        loss, info = loss_fn(batch, generator, draws)
        return torch.autograd.grad(loss, state.params, allow_unused=True, materialize_grads=True), info

    def train_step(state: TrainState, batch, generator: Optional[torch.Generator], draws=None):
        if k == 1:
            grads, info = grads_of(state, batch, generator, draws)
            grads = list(grads)
        else:
            if len(batch) != k:
                raise ValueError(f"expected {k} micro-batches, got {len(batch)}")
            grads, infos = None, []
            for i, micro in enumerate(batch):
                g, info = grads_of(state, micro, generator, None if draws is None else draws[i])
                grads = list(g) if grads is None else torch._foreach_add(grads, g)
                infos.append(info)
            torch._foreach_div_(grads, float(k))
            info = {key: torch.stack([m[key] for m in infos]).mean() for key in infos[0]}
        grads, grad_norm, max_norm = adaptive_clip(state, grads, enabled=clip_gradients)
        state.apply_gradients(grads)
        state.update_ema(ema_decay)
        metrics = {key: v.detach() for key, v in info.items()}
        metrics["grad_norm"] = grad_norm
        metrics["max_grad_norm"] = max_norm
        return metrics

    if diffusion_cfg.debug_invariants:
        return lambda *args, **kwargs: checked_call(train_step, *args, **kwargs)
    return train_step


def make_eval_step(evd, diffusion_cfg: DiffusionConfig, dataloader_cfg: DataloaderConfig,
                   log_pN_table: np.ndarray) -> Callable:
    """``eval_step(batch, generator, draws=None) -> info``: the NLL terms of
    ``evd`` (typically the EMA twin) without gradients."""
    loss_fn = make_loss_fn(evd, diffusion_cfg, dataloader_cfg, log_pN_table, training=False)

    def eval_step(batch, generator: Optional[torch.Generator], draws: Draws = None):
        with torch.no_grad():
            _, info = loss_fn(batch, generator, draws)
        return info

    if diffusion_cfg.debug_invariants:
        return lambda *args, **kwargs: checked_call(eval_step, *args, **kwargs)
    return eval_step
