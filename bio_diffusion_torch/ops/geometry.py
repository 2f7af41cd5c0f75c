"""Dense, masked geometry for molecule batches (kept in float32).

Port of ``bio_diffusion_tpu/ops/geometry.py``: nodes ``x [B, N, 3]`` with
``node_mask [B, N]``; the implicit fully-connected graph per molecule keeps
its self-loops (``edge_mask = m_i * m_j``), so the diagonal counts in edge
sums and means.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

Tensor = torch.Tensor


def safe_norm(x: Tensor, dim: int = -1, eps: float = 1e-8, keepdim: bool = False) -> Tensor:
    """``sqrt(sum(x^2) + eps) + eps`` (eps inside and outside the sqrt)."""
    return torch.sqrt(torch.sum(x * x, dim=dim, keepdim=keepdim) + eps) + eps


def safe_normalize(x: Tensor, dim: int = -1) -> Tensor:
    """``x / ||x||``, and 0 where ``||x|| == 0``."""
    sq = torch.sum(x * x, dim=dim, keepdim=True)
    pos = sq > 0
    norm = torch.sqrt(torch.where(pos, sq, torch.ones_like(sq)))
    return torch.where(pos, x / norm, torch.zeros_like(x))


def _guarded_sqrt(sq: Tensor) -> Tensor:
    """sqrt(sq) that is exactly 0 at sq == 0."""
    pos = sq > 0
    return torch.where(pos, torch.sqrt(torch.where(pos, sq, torch.ones_like(sq))), torch.zeros_like(sq))


def centralize(x: Tensor, node_mask: Tensor) -> Tuple[Tensor, Tensor]:
    """Masked zero-centre-of-mass projection: ``(centroid [B, 3], centred [B, N, 3])``.

    The centroid divides by the count of real nodes; padded rows stay 0."""
    m = node_mask.to(x.dtype)
    count = torch.clamp(m.sum(dim=-1, keepdim=True), min=1.0)
    centroid = torch.sum(x * m[..., None], dim=-2) / count
    return centroid, x - centroid[..., None, :] * m[..., None]


def localize(x: Tensor, edge_mask: Tensor, norm_x_diff: bool = True) -> Tensor:
    """Per-edge local frames ``f_ij [B, N, N, 3, 3]`` (axes on dim -2).

    ``a0 = (x_i - x_j) / (||.|| + 1)``, ``a1 = (x_i x x_j) / (||.|| + 1)``,
    ``a2 = a0 x a1``; zero at masked edges and on the diagonal."""
    x_i = x[..., :, None, :]
    x_j = x[..., None, :, :]
    x_diff = x_i - x_j
    x_cross = torch.cross(x_i.expand_as(x_diff), x_j.expand_as(x_diff), dim=-1)
    if norm_x_diff:
        x_diff = x_diff / (_guarded_sqrt(torch.sum(x_diff * x_diff, dim=-1, keepdim=True)) + 1.0)
        x_cross = x_cross / (_guarded_sqrt(torch.sum(x_cross * x_cross, dim=-1, keepdim=True)) + 1.0)
    x_vertical = torch.cross(x_diff, x_cross, dim=-1)
    frames = torch.stack([x_diff, x_cross, x_vertical], dim=-2)
    return frames * edge_mask[..., None, None].to(frames.dtype)


def node_mean_frames(frames: Tensor, edge_mask: Tensor) -> Tensor:
    """Mean frame over each node's valid out-edges (self-loop included)."""
    count = torch.sum(edge_mask.to(frames.dtype), dim=-1)
    return frames.sum(dim=-3) / torch.clamp(count, min=1.0)[..., None, None]


def orientations(x: Tensor, node_mask: Optional[Tensor] = None) -> Tensor:
    """Forward/backward unit vectors to the next/previous node, ``[B, N, 2, 3]``.

    Each molecule row is zero-padded on both ends, so ``forward[n-1] =
    -normalize(x[n-1])`` and ``backward[0] = -normalize(x[0])``."""
    zero = torch.zeros_like(x[..., :1, :])
    nxt = torch.cat([x[..., 1:, :], zero], dim=-2)
    prv = torch.cat([zero, x[..., :-1, :]], dim=-2)
    out = torch.stack([safe_normalize(nxt - x), safe_normalize(prv - x)], dim=-2)
    if node_mask is not None:
        out = out * node_mask[..., None, None].to(out.dtype)
    return out


def edge_features(x: Tensor, edge_mask: Tensor) -> Tuple[Tensor, Tensor]:
    """Squared distance ``[B, N, N, 1]`` and unit direction ``[B, N, N, 1, 3]``."""
    diff = x[..., :, None, :] - x[..., None, :, :]
    radial = torch.sum(diff * diff, dim=-1, keepdim=True)
    direction = safe_normalize(diff)[..., None, :]
    m = edge_mask.to(x.dtype)
    return radial * m[..., None], direction * m[..., None, None]


def build_edge_mask(node_mask: Tensor) -> Tensor:
    """Edge mask of the fully-connected graph with self-loops, float32."""
    m = node_mask.to(torch.float32)
    return m[..., :, None] * m[..., None, :]
