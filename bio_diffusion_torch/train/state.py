"""Train state: AMSGrad moments, EMA weights, adaptive grad-norm clipping.

Port of ``bio_diffusion_tpu/train/state.py``:

* AMSGrad in optax's order (``optax.scale_by_amsgrad``): the running maximum
  is taken over the *bias-corrected* second moment, then decoupled weight
  decay, then ``-lr`` (the ``optax.chain`` of ``make_optimizer``).  PyTorch's
  ``AdamW(amsgrad=True)`` takes the maximum over the raw second moment and
  corrects afterwards; the two drift apart after the first step, so the
  update is written out here on tensors.
* EMA of the weights, ``decay * ema + (1 - decay) * params``.
* Adaptive clipping to 1.5 * mean + 2 * std of the last 50 grad norms, the
  history a circular buffer on the device seeded with one value of 3000.

Everything that changes per step stays on the device; the host keeps only
the step counts, which it advances itself (no device-to-host read per step).

Under a ``model`` axis (``shard_``, ``parallel/mesh.py``; the JAX Trainer's
``shard_pytree(param_sharding_rules(state))``) the state keeps this rank's
slices of the parameters, the EMA and the three moments
(``param_shards``, ``ema_shards``, ``mu``, ``nu``, ``nu_max``; a replicated
leaf's shard is the leaf itself) and the model's and the EMA twin's
sharded parameters are released; ``gather_params_`` / ``release_params_``
(or ``gathered``) move them between full and released.  AMSGrad, weight
decay and the EMA update the shards elementwise; the grad-norm history and
the counts stay whole on every rank.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, Iterator, List, Sequence, Tuple, Union

import torch
from torch import nn

from bio_diffusion_torch.config.schema import OptimizerConfig

Tensor = torch.Tensor

GRADNORM_QUEUE_LEN = 50
GRADNORM_INIT = 3000.0
MOMENTS = ("mu", "nu", "nu_max")


def make_lr_schedule(cfg: OptimizerConfig) -> Union[float, Callable[[int], float]]:
    """The learning rate: a float, or a function of the optimizer step count
    (0 for the first update), as optax's schedules of the JAX package."""
    if not cfg.scheduler and cfg.warmup_steps <= 0:
        return cfg.lr
    if cfg.scheduler == "step":
        def base(count):  # torch StepLR: lr * gamma^(count // step_size)
            return cfg.lr * cfg.gamma ** math.floor(count / cfg.step_size)
    elif cfg.scheduler == "cosine":
        decay_steps = max(cfg.step_size, 1)

        def base(count):
            return cfg.lr * 0.5 * (1.0 + math.cos(math.pi * min(count, decay_steps) / decay_steps))
    elif cfg.scheduler in ("", "linear_warmup"):
        def base(count):
            return cfg.lr
    else:
        raise ValueError(f"unknown scheduler {cfg.scheduler!r}")
    if cfg.warmup_steps <= 0:
        return base
    warm = cfg.warmup_steps

    def schedule(count):
        if count < warm:
            return cfg.lr * count / warm
        return base(count - warm)
    return schedule


def drop_weight_caches(module: nn.Module) -> None:
    """Drop the weights a module's submodules cached from their parameters
    (the packed message-layer weights, a learned schedule's table)."""
    for m in module.modules():
        drop = getattr(m, "drop_weight_cache", None)
        if drop is not None:
            drop()


class TrainState:
    """The optimizer's state over ``params`` (updated in place) and the EMA
    tensors ``ema_params`` (updated in place; typically the parameters of an
    EMA twin of the model, so that it can run evaluation).  ``shard_`` puts
    it on a model axis."""

    def __init__(self, params: Sequence[Tensor], ema_params: Sequence[Tensor], cfg: OptimizerConfig):
        self.params: List[Tensor] = list(params)
        self.ema_params: List[Tensor] = list(ema_params)
        if len(self.params) != len(self.ema_params):
            raise ValueError("params and ema_params differ in length")
        self.cfg = cfg
        self.lr = make_lr_schedule(cfg)
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.nu_max = [torch.zeros_like(p) for p in self.params]
        self.count = 0  # optimizer steps taken
        self.gradnorm_buffer = torch.zeros(GRADNORM_QUEUE_LEN, dtype=torch.float32,
                                           device=self.params[0].device)
        self.gradnorm_buffer[0] = GRADNORM_INIT
        self.gradnorm_count = 1  # filled entries pushed so far (host)
        # the model axis: this rank's slices (the full leaves themselves
        # without one) and which full copies hold current values
        self.shards = None
        self.param_shards, self.ema_shards = self.params, self.ema_params
        self._full = {"params": True, "ema": True}
        self._owners: Tuple[nn.Module, ...] = ()

    def shard_(self, shards, modules: Sequence[nn.Module] = ()) -> None:
        """Keep this rank's slices (``shards``, a ``parallel.mesh.ModelShards``
        over these parameters) of the parameters, the EMA and the moments,
        and release the full parameters.  ``modules``: the modules that own
        ``params`` and ``ema_params``, whose cached weights are dropped on
        every release."""
        self.shards, self._owners = shards, tuple(modules)
        self.param_shards = shards.slice(self.params)
        self.ema_shards = shards.slice(self.ema_params)
        for key in MOMENTS:
            setattr(self, key, shards.slice(getattr(self, key)))
        self.release_params_()

    def _fulls(self, key: str) -> Tuple[List[Tensor], List[Tensor]]:
        return (self.param_shards, self.params) if key == "params" else (self.ema_shards, self.ema_params)

    def gather_params_(self, params: bool = True, ema: bool = False) -> None:
        """Gather the full parameters (and/or the EMA twin's) from the
        model group's shards into the modules' own tensors (a collective of
        the model group); a no-op where they are full."""
        for key, wanted in (("params", params), ("ema", ema)):
            if wanted and not self._full[key]:
                self.shards.gather_(*self._fulls(key))
                self._full[key] = True

    def release_params_(self, params: bool = True, ema: bool = True) -> None:
        """Free the full copies of the sharded parameters (and/or the EMA
        twin's) and the weights cached from them; a no-op without shards."""
        if self.shards is None:
            return
        keys = [key for key, wanted in (("params", params), ("ema", ema)) if wanted and self._full[key]]
        for key in keys:
            self.shards.release_(self._fulls(key)[1])
            self._full[key] = False
        if keys:
            for module in self._owners:
                drop_weight_caches(module)

    @contextlib.contextmanager
    def gathered(self, params: bool = True, ema: bool = True) -> Iterator["TrainState"]:
        """The full parameters and/or EMA weights for the block (every rank
        of the model group enters it); what was released before is released
        after it."""
        was = dict(self._full)
        self.gather_params_(params, ema)
        try:
            yield self
        finally:
            self.release_params_(params=params and not was["params"], ema=ema and not was["ema"])

    def full_moments(self) -> Dict[str, List[Tensor]]:
        """``mu``, ``nu`` and ``nu_max`` at the parameters' full shapes (on
        a model axis gathered into new tensors: a collective)."""
        if self.shards is None:
            return {key: getattr(self, key) for key in MOMENTS}
        return {key: self.shards.gather(getattr(self, key)) for key in MOMENTS}

    def grad_norm(self, grads: Sequence[Tensor]) -> Tensor:
        """The global L2 norm of the gradients (``grads``: this rank's shards
        on a model axis, each replicated leaf counted once)."""
        return global_norm(grads) if self.shards is None else self.shards.global_norm(grads)

    def queue_stats(self) -> Tuple[Tensor, Tensor]:
        """Mean and std over the filled part of the grad-norm history."""
        filled = self.gradnorm_buffer[:min(self.gradnorm_count, GRADNORM_QUEUE_LEN)]
        mean = filled.sum() / filled.numel()
        var = ((filled - mean) ** 2).sum() / filled.numel()
        return mean, torch.sqrt(var)

    def push_gradnorm(self, value: Tensor) -> None:
        self.gradnorm_buffer[self.gradnorm_count % GRADNORM_QUEUE_LEN] = value
        self.gradnorm_count += 1

    def current_lr(self) -> float:
        return self.lr(self.count) if callable(self.lr) else self.lr

    @torch.no_grad()
    def apply_gradients(self, grads: Sequence[Tensor]) -> None:
        """One AMSGrad + weight decay + learning-rate update of the params
        (on a model axis: of the shards, ``grads`` being this rank's)."""
        b1, b2, eps = self.cfg.b1, self.cfg.b2, self.cfg.eps
        lr = self.current_lr()
        grads = list(grads)
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, grads, alpha=1.0 - b1)
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - b2)
        self.count += 1
        mu_hat = torch._foreach_div(self.mu, 1.0 - b1 ** self.count)
        nu_hat = torch._foreach_div(self.nu, 1.0 - b2 ** self.count)
        torch._foreach_maximum_(self.nu_max, nu_hat)
        denom = torch._foreach_sqrt(self.nu_max)
        torch._foreach_add_(denom, eps)
        updates = torch._foreach_div(mu_hat, denom)
        if self.cfg.weight_decay:
            torch._foreach_add_(updates, self.param_shards, alpha=self.cfg.weight_decay)
        torch._foreach_add_(self.param_shards, updates, alpha=-lr)

    @torch.no_grad()
    def update_ema(self, decay: float) -> None:
        torch._foreach_mul_(self.ema_shards, decay)
        torch._foreach_add_(self.ema_shards, self.param_shards, alpha=1.0 - decay)


def squared_norm(tensors: Sequence[Tensor], device=None) -> Tensor:
    """The sum of the squares of every element of ``tensors``, in float32
    (0 on ``device`` for none)."""
    if not tensors:
        return torch.zeros((), dtype=torch.float32, device=device)
    return torch.stack(torch._foreach_norm([t.float() for t in tensors])).square().sum()


def global_norm(tensors: Sequence[Tensor]) -> Tensor:
    return torch.sqrt(squared_norm(tensors))


@torch.no_grad()
def adaptive_clip(state: TrainState, grads: List[Tensor], enabled: bool = True
                  ) -> Tuple[List[Tensor], Tensor, Tensor]:
    """Clip ``grads`` to 1.5 * mean + 2 * std of the recent grad-norm
    history (torch ``clip_grad_norm_`` semantics: scale by max_norm / (norm +
    1e-6) only when that is below 1) and push min(norm, max_norm).

    Returns ``(grads, grad_norm, max_norm)``; the grads are scaled in place.
    On a model axis ``grads`` are this rank's shards and the norm is the
    full leaves' (``TrainState.grad_norm``)."""
    grad_norm = state.grad_norm(grads)
    if not enabled:
        return grads, grad_norm, torch.full_like(grad_norm, math.inf)
    mean, std = state.queue_stats()
    max_norm = 1.5 * mean + 2.0 * std
    coef = max_norm / (grad_norm + 1e-6)
    torch._foreach_mul_(grads, torch.where(coef < 1.0, coef, torch.ones_like(coef)))
    state.push_gradnorm(torch.minimum(grad_norm, max_norm))
    return grads, grad_norm, max_norm
