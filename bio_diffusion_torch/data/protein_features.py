"""Protein graph features (GVP style), as torch functions.

Port of ``bio_diffusion_tpu/data/protein_features.py``: radial-basis
distance embeddings, backbone dihedrals, imputed side-chain directions,
sinusoidal positional embeddings of sequence offsets, and static-shape
masked kNN and radius graphs.  Nothing on the port's paths calls them yet
(nor in the JAX package); they are kept for pocket featurization.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from bio_diffusion_torch.ops.geometry import safe_normalize

Tensor = torch.Tensor


def rbf(d: Tensor, d_min: float = 0.0, d_max: float = 20.0, d_count: int = 16) -> Tensor:
    """Radial basis embedding of distances along a new trailing axis."""
    mu = torch.linspace(d_min, d_max, d_count, dtype=d.dtype, device=d.device)
    sigma = (d_max - d_min) / d_count
    return torch.exp(-(((d[..., None] - mu) / sigma) ** 2))


def dihedrals(x: Tensor, eps: float = 1e-7) -> Tensor:
    """Backbone dihedral features ``[n, 6]``, (cos, sin) of phi, psi, omega,
    from ``x [n, 3 (N, CA, C), 3]``."""
    flat = x.reshape(-1, 3)
    u = safe_normalize(flat[1:] - flat[:-1])
    u2, u1, u0 = u[:-2], u[1:-1], u[2:]
    n2 = safe_normalize(torch.linalg.cross(u2, u1))
    n1 = safe_normalize(torch.linalg.cross(u1, u0))
    cos_d = torch.clamp(torch.sum(n2 * n1, dim=-1), -1 + eps, 1 - eps)
    d = torch.sign(torch.sum(u2 * n1, dim=-1)) * torch.arccos(cos_d)
    d = F.pad(d, (1, 2)).reshape(-1, 3)
    return torch.cat([torch.cos(d), torch.sin(d)], dim=-1)


def sidechains(x: Tensor) -> Tensor:
    """Imputed C-beta directions ``[n, 3]`` from N, CA, C."""
    n, origin, c = x[:, 0], x[:, 1], x[:, 2]
    c = safe_normalize(c - origin)
    n = safe_normalize(n - origin)
    bisector = safe_normalize(c + n)
    perp = safe_normalize(torch.linalg.cross(c, n))
    return -bisector * math.sqrt(1 / 3) - perp * math.sqrt(2 / 3)


def positional_embeddings(offsets: Tensor, num_embeddings: int = 16) -> Tensor:
    """Sinusoidal embeddings of (signed) sequence offsets."""
    freq = torch.exp(torch.arange(0, num_embeddings, 2, dtype=torch.float32, device=offsets.device)
                     * -(math.log(10000.0) / num_embeddings))
    angles = offsets[..., None] * freq
    return torch.cat([torch.cos(angles), torch.sin(angles)], dim=-1)


def masked_knn_graph(x: Tensor, node_mask: Tensor, k: int, include_self: bool = False) -> Tuple[Tensor, Tensor]:
    """For each node of ``x [N, 3]`` its ``k`` nearest valid neighbours ->
    ``(neighbor_idx [N, k] int32, neighbor_mask [N, k])``; a slot without a
    valid neighbour has mask 0.  Ties go to the lower index, as in
    ``jax.lax.top_k``."""
    n = x.shape[0]
    diff = x[:, None, :] - x[None, :, :]
    d2 = torch.sum(diff * diff, dim=-1)
    valid = (node_mask[None, :] > 0) & (node_mask[:, None] > 0)
    if not include_self:
        valid = valid & ~torch.eye(n, dtype=torch.bool, device=x.device)
    big = torch.tensor(1e9, dtype=d2.dtype, device=x.device)
    d2 = torch.where(valid, d2, big)
    idx = torch.argsort(d2, dim=-1, stable=True)[:, :k]
    nbr_mask = torch.gather(d2, 1, idx) < big / 2
    return idx.to(torch.int32), nbr_mask.to(x.dtype)


def masked_radius_graph(x: Tensor, node_mask: Tensor, radius: float, max_neighbors: int) -> Tuple[Tensor, Tensor]:
    """Up to ``max_neighbors`` valid neighbours within ``radius``."""
    idx, nbr_mask = masked_knn_graph(x, node_mask, max_neighbors)
    d = torch.linalg.norm(x[:, None, :] - x[idx.long()], dim=-1)
    return idx, nbr_mask * (d <= radius).to(x.dtype)
