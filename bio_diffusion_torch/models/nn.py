"""Small building blocks of the module-path denoiser: nonlinearities, the
GCP norm and the GCP dropout.

Port of ``bio_diffusion_tpu/models/nn.py`` (``get_nonlinearity``,
``norm_vector``, ``GCPLayerNorm``, ``GCPDropout``).  Dropout masks come from
an explicit generator (:class:`DropoutDraws`), never from the global RNG,
and only where the caller hands draws in: the training loss does
(``EquivariantVariationalDiffusion.loss_terms``), every other call runs
deterministically, as JAX's ``deterministic=not training``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from bio_diffusion_torch.ops.scalar_vector import ScalarVector

Tensor = torch.Tensor


def is_identity(name: Optional[str]) -> bool:
    return name is None or name.lower().strip() in ("identity", "none")


def get_nonlinearity(name: Optional[str], slope: float = 1e-2) -> Callable[[Tensor], Tensor]:
    """The activation named ``name`` (reference ``src/models/__init__.py:30-45``)."""
    if is_identity(name):
        return lambda x: x
    name = name.lower().strip()
    acts = {"relu": F.relu, "leakyrelu": lambda x: F.leaky_relu(x, negative_slope=slope), "selu": F.selu,
            "silu": F.silu, "sigmoid": torch.sigmoid}
    if name not in acts:
        raise NotImplementedError(f"Nonlinearity {name} is not implemented.")
    return acts[name]


def norm_vector(v: Tensor, eps: float = 1e-8) -> Tensor:
    """Vector channels ``[..., V, 3]`` divided by the root of the mean over
    channels of their squared norms (each clamped at ``eps``)."""
    sq = torch.clamp(torch.sum(v * v, dim=-1, keepdim=True), min=eps)
    return v / torch.sqrt(torch.mean(sq, dim=-2, keepdim=True))


class GCPLayerNorm(nn.Module):
    """LayerNorm of the scalars (``scalar_norm``, eps 1e-5) and RMS norm of the
    vector channels (eps 1e-8); without ``use_gcp_norm`` an identity with no
    parameters.  The scalar norm is flax's LayerNorm: float32 statistics
    (a bfloat16 input is promoted with the float32 parameters, and so is the
    output), the variance as E[x^2] - E[x]^2 clipped at 0; over one channel
    (the edge embedding's squared distance) x - E[x] is exactly 0, so its
    weight's gradient is too."""

    def __init__(self, scalar_dim: int, use_gcp_norm: bool = True, eps: float = 1e-8):
        super().__init__()
        self.use_gcp_norm, self.eps = use_gcp_norm, eps
        if use_gcp_norm:
            self.scalar_norm = nn.LayerNorm(scalar_dim, eps=1e-5)

    def forward(self, x: ScalarVector) -> ScalarVector:
        if not self.use_gcp_norm:
            return x
        ln, s = self.scalar_norm, x.scalar.float()
        mean = s.mean(dim=-1, keepdim=True)
        var = torch.clamp((s * s).mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
        s = (s - mean) * (torch.rsqrt(var + ln.eps) * ln.weight) + ln.bias
        if x.vector.shape[-2] == 0:
            return ScalarVector(s, x.vector)
        return ScalarVector(s, norm_vector(x.vector, eps=self.eps))


@dataclasses.dataclass
class DropoutDraws:
    """Where a denoiser call's dropout masks come from: ``generator``, drawn
    at the shape of the whole batch of ``batch_size`` rows (the call's own
    rows when None), of which the call keeps ``rows`` -- so a data-parallel
    rank draws what one process draws and takes its rows
    (``train/step.py``)."""

    generator: Optional[torch.Generator]
    batch_size: Optional[int] = None
    rows: slice = slice(None)

    def keep(self, shape: Tuple[int, ...], p: float, device) -> Tensor:
        """A bool mask of ``shape`` (rows first), each entry kept with probability 1-p."""
        if self.generator is None:
            raise ValueError("dropout in training draws from a generator: pass one to loss_terms")
        full = (self.batch_size or shape[0],) + tuple(shape[1:])
        return (torch.rand(full, generator=self.generator, device=device) >= p)[self.rows]


class GCPDropout(nn.Module):
    """Dropout of the scalars and of whole vector channels (the three
    coordinates of a channel together), survivors scaled by 1/(1-p); an
    identity without draws, at rate 0 or without ``use_gcp_dropout``."""

    def __init__(self, rate: float, use_gcp_dropout: bool = True):
        super().__init__()
        self.rate, self.use_gcp_dropout = float(rate), use_gcp_dropout

    def forward(self, x: ScalarVector, draws: Optional[DropoutDraws] = None) -> ScalarVector:
        p = self.rate
        if draws is None or not self.use_gcp_dropout or p == 0.0:
            return x

        def drop(a: Tensor, shape) -> Tensor:
            keep = draws.keep(shape, p, a.device)
            while keep.dim() < a.dim():
                keep = keep[..., None]
            return a * keep.to(a.dtype) / (1.0 - p)

        return ScalarVector(drop(x.scalar, x.scalar.shape), drop(x.vector, x.vector.shape[:-1]))
