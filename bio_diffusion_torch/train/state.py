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
"""

from __future__ import annotations

import math
from typing import Callable, List, Sequence, Tuple, Union

import torch

from bio_diffusion_torch.config.schema import OptimizerConfig

Tensor = torch.Tensor

GRADNORM_QUEUE_LEN = 50
GRADNORM_INIT = 3000.0


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


class TrainState:
    """The optimizer's state over ``params`` (updated in place) and the EMA
    tensors ``ema_params`` (updated in place; typically the parameters of an
    EMA twin of the model, so that it can run evaluation)."""

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
        """One AMSGrad + weight decay + learning-rate update of the params."""
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
            torch._foreach_add_(updates, self.params, alpha=self.cfg.weight_decay)
        torch._foreach_add_(self.params, updates, alpha=-lr)

    @torch.no_grad()
    def update_ema(self, decay: float) -> None:
        torch._foreach_mul_(self.ema_params, decay)
        torch._foreach_add_(self.ema_params, self.params, alpha=1.0 - decay)


def global_norm(tensors: Sequence[Tensor]) -> Tensor:
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm([t.float() for t in tensors])))


@torch.no_grad()
def adaptive_clip(state: TrainState, grads: List[Tensor], enabled: bool = True
                  ) -> Tuple[List[Tensor], Tensor, Tensor]:
    """Clip ``grads`` to 1.5 * mean + 2 * std of the recent grad-norm
    history (torch ``clip_grad_norm_`` semantics: scale by max_norm / (norm +
    1e-6) only when that is below 1) and push min(norm, max_norm).

    Returns ``(grads, grad_norm, max_norm)``; the grads are scaled in place."""
    grad_norm = global_norm(grads)
    if not enabled:
        return grads, grad_norm, torch.full_like(grad_norm, math.inf)
    mean, std = state.queue_stats()
    max_norm = 1.5 * mean + 2.0 * std
    coef = max_norm / (grad_norm + 1e-6)
    torch._foreach_mul_(grads, torch.where(coef < 1.0, coef, torch.ones_like(coef)))
    state.push_gradnorm(torch.minimum(grad_norm, max_norm))
    return grads, grad_norm, max_norm
