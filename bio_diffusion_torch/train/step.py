"""Train and eval steps: loss -> grad -> clip -> AMSGrad -> EMA.

Port of ``bio_diffusion_tpu/train/step.py``.  A step runs on the device end
to end and returns its metrics as device tensors: nothing is read back to
the host per step.  Draws come from a ``torch.Generator`` unless given as
tensors (``draws``: ``t_int [B, 1]``, ``eps_t`` and, for evaluation, ``eps_0``;
with self-conditioning ``sc_take``, ``eps_sc`` and ``eps_sc_step``), which
is how the tests feed in the JAX package's draws.  The Trainer seeds a
step's generator from the run's seed and the step's count (``step_seed``),
as the JAX step folds the count into its key, so a resumed run draws what
the uninterrupted run draws.

With ``diffusion_cfg.debug_invariants`` (``trainer.detect_anomaly`` or
``debug=default``) the loss's invariant checks (``utils/debug.py``) are
recorded on the device over the whole step, every micro-batch included,
and read back once after it: a failed check raises ``InvariantError``.
Off, the steps run no check and read nothing back.

Data parallelism (``dp``, a ``parallel.distributed.DataParallel``): every
rank is handed the same global batch and the same seeded generator, draws
the whole batch's draws in ``loss_terms``' order (``evd.loss_draws``) and keeps
its rows of both (``shard_rows``), and draws GCP dropout's masks at the
global batch's shape and keeps its rows of them too, so world W computes
what world 1 does for the same seed, as a sharded array does in the JAX
package.  The self-conditioning decision belongs to the whole batch:
``sc_take`` goes to every rank whole, folded with "no row of the global
batch has t_int = T" before the split.  The
gradients (averaged over the micro-batches first) and the step's metrics
are all-reduced in one call before the clip, so the clip, AMSGrad and the
EMA see the same values on every rank; there is no DDP wrapper, because
``torch.autograd.grad`` never runs the ``AccumulateGrad`` hooks that
``DistributedDataParallel`` reduces in.  The invariant checks' flags are
reduced too, so a failed check raises on every rank together.  The eval
step keeps its rows and returns its local means (``Trainer.validate``
reduces them once).  ``make_eval_step(devices=[...])`` splits a batch over
the devices of one process instead (the inference CLIs' NLL).

On a model axis (``dp.model > 1``, a ``state`` put on it by
``TrainState.shard_``) the step gathers the full parameters from the model
group's shards first, computes on this rank's rows as above, releases them
after the backward, and reduces the gradients with
``parallel.mesh.ModelShards.reduce_gradients`` (reduce-scatter inside the
model group, all-reduce across the data group; the replicated leaves and
the metrics over the world); the clip, AMSGrad and the EMA then run on the
shards.  The kernels run unchanged on the gathered weights.  The eval step
runs on whatever weights the model holds (the Trainer gathers the EMA
twin's for validation).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from bio_diffusion_torch.config.schema import DataloaderConfig, DiffusionConfig, compute_num_atom_types
from bio_diffusion_torch.data.batch import DenseMolBatch
from bio_diffusion_torch.models.diffusion import assemble_nll
from bio_diffusion_torch.ops.geometry import centralize
from bio_diffusion_torch.parallel import distributed
from bio_diffusion_torch.parallel.distributed import DataParallel, row_slice, shard_rows
from bio_diffusion_torch.train.state import TrainState, adaptive_clip
from bio_diffusion_torch.utils.debug import checked_call
from bio_diffusion_torch.utils.profiling import span

Tensor = torch.Tensor
Draws = Optional[Dict[str, Tensor]]


def make_loss_fn(evd, diffusion_cfg: DiffusionConfig, dataloader_cfg: DataloaderConfig,
                 log_pN_table: np.ndarray, training: bool) -> Callable:
    """``loss_fn(batch, generator, draws=None) -> (mean nll, info)`` for a
    batch of torch tensors on the model's device; a conditioned model reads
    the batch's context."""
    nsf = compute_num_atom_types(dataloader_cfg) + int(dataloader_cfg.include_charges)
    tables: Dict[torch.device, Tensor] = {}

    def loss_fn(batch: DenseMolBatch, generator: Optional[torch.Generator], draws: Draws = None,
                max_num_nodes: Optional[Tensor] = None, dropout_rows: Optional[Tuple[int, slice]] = None):
        dev = batch.x.device
        if dev not in tables:
            tables[dev] = torch.as_tensor(log_pN_table, dtype=torch.float32, device=dev)
        table = tables[dev]
        _, x = centralize(batch.x, batch.node_mask)
        terms = evd.loss_terms(x, batch.one_hot, batch.charges, batch.node_mask, training,
                               generator=generator, context=batch.context, dropout_rows=dropout_rows,
                               **(draws or {}))
        num_nodes = batch.node_mask.sum(dim=-1).long()
        log_pN = table[torch.clamp(num_nodes, 0, table.shape[0] - 1)]
        nll, info = assemble_nll(
            terms, loss_type=diffusion_cfg.loss_type, training=training,
            T=diffusion_cfg.num_timesteps, num_x_dims=dataloader_cfg.num_x_dims,
            num_node_scalar_features=nsf, log_pN=log_pN,
            norm_training_by_max_nodes=diffusion_cfg.norm_training_by_max_nodes, max_num_nodes=max_num_nodes)
        return nll.mean(), info

    return loss_fn


def step_seed(seed: int, count: int) -> int:
    """The seed of the draws of the optimizer step that follows ``count``
    steps of a run seeded ``seed``: a hash of both (numpy ``SeedSequence``),
    so every step, resumed or not, draws from a stream of its own."""
    return int(np.random.SeedSequence([int(seed) + 1, int(count)]).generate_state(1, np.uint64)[0])


def _rank_rows(evd, dp: DataParallel, batch, generator, draws: Draws, training: bool, by_max_nodes: bool):
    """This rank's rows of a global batch and of its draws (drawn for the
    whole batch when not given), the batch's largest molecule where the
    loss normalizes by it, and the dropout masks' rows (the global batch's
    size and this rank's rows: the masks are drawn at the global shape).  A
    self-conditioning ``sc_take`` is the global batch's decision: it is
    folded with "no row's t_int is T" here, before the split, and goes to
    every rank whole."""
    if draws is None:
        draws = evd.loss_draws(batch.node_mask, generator, training)
    if draws.get("sc_take") is not None:
        t_int = draws["t_int"]
        draws = dict(draws, sc_take=torch.logical_and(torch.as_tensor(draws["sc_take"], device=t_int.device),
                                                      ~(t_int == evd.T).any()))
    max_num_nodes = batch.node_mask.sum(dim=-1).max() if by_max_nodes else None
    b = batch.node_mask.shape[0]
    return (shard_rows(batch, dp.rank, dp.world), shard_rows(draws, dp.rank, dp.world), max_num_nodes,
            (b, row_slice(b, dp.rank, dp.world)))


def _checked(fn: Callable, dp: Optional[DataParallel]) -> Callable:
    """``fn`` with its invariant checks read back after the call; under data
    parallelism their flags and values are reduced (max) over the ranks
    first, so every rank raises the same failure."""
    reduce_max = None if dp is None else (lambda flat: distributed.all_reduce_max_([flat], dp))
    return lambda *args, **kwargs: checked_call(fn, *args, reduce_max=reduce_max, **kwargs)


def make_train_step(evd, diffusion_cfg: DiffusionConfig, dataloader_cfg: DataloaderConfig,
                    log_pN_table: np.ndarray, ema_decay: float = 0.9999,
                    clip_gradients: bool = True, accumulate_grad_batches: int = 1,
                    dp: Optional[DataParallel] = None) -> Callable:
    """``train_step(state, batch, generator, draws=None) -> metrics``.

    Updates ``state`` (and so the model's parameters and the EMA) in place.
    With ``accumulate_grad_batches = k > 1`` the step takes a sequence of k
    micro-batches (and k draws): gradients are averaged over them and applied
    in one clipped update, the mean-loss big-batch step.  With ``dp`` each
    batch (and draws) is the global one: the rank keeps its rows and the
    gradients and metrics are averaged over the ranks."""
    loss_fn = make_loss_fn(evd, diffusion_cfg, dataloader_cfg, log_pN_table, training=True)
    k = max(1, int(accumulate_grad_batches))
    by_max_nodes = diffusion_cfg.norm_training_by_max_nodes

    def grads_of(state: TrainState, batch, generator, draws) -> Tuple[Sequence[Tensor], Dict]:
        max_num_nodes = rows = None
        if dp is not None:
            batch, draws, max_num_nodes, rows = _rank_rows(evd, dp, batch, generator, draws, True, by_max_nodes)
        with span("step.forward"):
            loss, info = loss_fn(batch, generator, draws, max_num_nodes, rows)
        with span("step.backward"):
            grads = torch.autograd.grad(loss, state.params, allow_unused=True, materialize_grads=True)
        return grads, info

    def train_step(state: TrainState, batch, generator: Optional[torch.Generator], draws=None):
        state.gather_params_()
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
        state.release_params_()
        metrics = {key: v.detach() for key, v in info.items()}
        if state.shards is not None:
            with span("step.reduce"):
                grads = state.shards.reduce_gradients(grads, list(metrics.values()))
        elif dp is not None:
            # one all-reduce: the gradients and the step's metrics
            with span("step.reduce"):
                distributed.all_reduce_mean_(list(grads) + list(metrics.values()), dp)
        with span("step.clip"):
            grads, grad_norm, max_norm = adaptive_clip(state, grads, enabled=clip_gradients)
        with span("step.optimizer"):
            state.apply_gradients(grads)
        with span("step.ema"):
            state.update_ema(ema_decay)
        metrics["grad_norm"] = grad_norm
        metrics["max_grad_norm"] = max_norm
        return metrics

    if diffusion_cfg.debug_invariants:
        return _checked(train_step, dp)
    return train_step


def make_eval_step(evd, diffusion_cfg: DiffusionConfig, dataloader_cfg: DataloaderConfig,
                   log_pN_table: np.ndarray, dp: Optional[DataParallel] = None,
                   devices: Optional[Sequence] = None) -> Callable:
    """``eval_step(batch, generator, draws=None) -> info``: the NLL terms of
    ``evd`` (typically the EMA twin) without gradients.

    With ``dp`` the batch is the global one and the info holds this rank's
    means (the caller reduces them).  With ``devices`` (any number; the
    inference CLIs) the batch is split over a replica of ``evd`` on each
    (``Replicas``), its draws drawn whole on the first, and the info is the
    mean over the replicas, on the first; a batch that does not divide runs
    whole on the first device."""
    if devices is not None:
        return _replicated_eval_step(evd, diffusion_cfg, dataloader_cfg, log_pN_table, devices)
    loss_fn = make_loss_fn(evd, diffusion_cfg, dataloader_cfg, log_pN_table, training=False)

    def eval_step(batch, generator: Optional[torch.Generator], draws: Draws = None):
        max_num_nodes = None
        if dp is not None:
            batch, draws, max_num_nodes, _ = _rank_rows(evd, dp, batch, generator, draws, False, False)
        with torch.no_grad():
            _, info = loss_fn(batch, generator, draws, max_num_nodes)
        return info

    if diffusion_cfg.debug_invariants:
        return _checked(eval_step, dp)
    return eval_step


def _replicated_eval_step(evd, diffusion_cfg, dataloader_cfg, log_pN_table, devices) -> Callable:
    reps = distributed.Replicas(evd, devices)
    devices, nd = reps.devices, len(reps)
    steps = [make_eval_step(m, diffusion_cfg, dataloader_cfg, log_pN_table) for m in reps.modules]

    def eval_step(batch, generator: Optional[torch.Generator], draws: Draws = None):
        batch = batch.to(devices[0])
        if draws is None:
            draws = evd.loss_draws(batch.node_mask, generator, training=False)
        if batch.node_mask.shape[0] % nd:
            return steps[0](batch, generator, draws)
        infos: List[Dict[str, Tensor]] = []
        for i, (step, dev) in enumerate(zip(steps, devices)):
            rows = shard_rows(batch, i, nd).to(dev)
            infos.append(step(rows, None, {key: v.to(dev) for key, v in shard_rows(draws, i, nd).items()}))
        return {key: torch.stack([info[key].to(devices[0]) for info in infos]).mean() for key in infos[0]}

    return eval_step
