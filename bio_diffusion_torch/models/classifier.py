"""EGNN property classifier: the regressor that scores property-conditioned
generation.

Port of ``bio_diffusion_tpu/models/classifier.py`` (``EGCLMask``,
``EGNNClassifier``, the reference-directory loader).  The modules carry the
reference's parameter names (``embedding``, ``gcl_<i>.edge_mlp.0/.2``,
``gcl_<i>.node_mlp.0/.2``, ``gcl_<i>.att_mlp.0``, ``node_dec.0/.2``,
``graph_dec.0/.2``), so a reference classifier directory (``args.pickle`` +
``best_checkpoint.npy``) loads with ``strict=True`` and no key mapping.  The
products are ``nn.Linear``: the JAX package computes them outside any Pallas
kernel too.
"""

from __future__ import annotations

import os
import pickle
from typing import Optional

import torch
from torch import nn

Tensor = torch.Tensor


class EGCLMask(nn.Module):
    """Masked E_GCL layer without coordinate updates: edge MLP over
    ``[h_i | h_j | |x_i - x_j|^2]``, optional sigmoid attention, masked sum
    over neighbours, residual node MLP."""

    def __init__(self, hidden_nf: int, nodes_attr_dim: int = 0, attention: bool = False):
        super().__init__()
        self.attention = attention
        self.edge_mlp = nn.Sequential(nn.Linear(2 * hidden_nf + 1, hidden_nf), nn.SiLU(),
                                      nn.Linear(hidden_nf, hidden_nf), nn.SiLU())
        self.node_mlp = nn.Sequential(nn.Linear(2 * hidden_nf + nodes_attr_dim, hidden_nf), nn.SiLU(),
                                      nn.Linear(hidden_nf, hidden_nf))
        if attention:
            self.att_mlp = nn.Sequential(nn.Linear(hidden_nf, 1), nn.Sigmoid())

    def forward(self, h: Tensor, x: Tensor, edge_mask: Tensor, node_attr: Optional[Tensor] = None) -> Tensor:
        """``h [B, N, H]``, ``x [B, N, 3]``, ``edge_mask [B, N, N]`` (no self-loops) -> ``[B, N, H]``."""
        b, n, hid = h.shape
        diff = x[:, :, None, :] - x[:, None, :, :]
        radial = (diff * diff).sum(dim=-1, keepdim=True)
        e_in = torch.cat([h[:, :, None].expand(b, n, n, hid), h[:, None, :].expand(b, n, n, hid), radial], dim=-1)
        m = self.edge_mlp(e_in)
        if self.attention:
            m = m * self.att_mlp(m)
        agg = (m * edge_mask[..., None].to(m.dtype)).sum(dim=-2)
        parts = [h, agg] + ([node_attr] if node_attr is not None else [])
        return h + self.node_mlp(torch.cat(parts, dim=-1))


class EGNNClassifier(nn.Module):
    """Per-molecule property regressor: ``(h0 [B, N, K] one-hot, x [B, N, 3],
    node_mask [B, N]) -> [B]`` (the normalized property)."""

    def __init__(self, in_node_nf: int = 5, hidden_nf: int = 128, n_layers: int = 7, attention: bool = True,
                 node_attr: int = 0):
        super().__init__()
        self.in_node_nf, self.hidden_nf, self.n_layers = in_node_nf, hidden_nf, n_layers
        self.attention, self.node_attr = attention, node_attr
        self.embedding = nn.Linear(in_node_nf, hidden_nf)
        for i in range(n_layers):
            self.add_module(f"gcl_{i}", EGCLMask(hidden_nf, in_node_nf if node_attr else 0, attention))
        self.node_dec = nn.Sequential(nn.Linear(hidden_nf, hidden_nf), nn.SiLU(), nn.Linear(hidden_nf, hidden_nf))
        self.graph_dec = nn.Sequential(nn.Linear(hidden_nf, hidden_nf), nn.SiLU(), nn.Linear(hidden_nf, 1))

    def forward(self, h0: Tensor, x: Tensor, node_mask: Tensor) -> Tensor:
        m = node_mask.to(h0.dtype)
        n = h0.shape[1]
        em = m[:, :, None] * m[:, None, :] * (1.0 - torch.eye(n, dtype=m.dtype, device=m.device))
        h = self.embedding(h0)
        for i in range(self.n_layers):
            h = getattr(self, f"gcl_{i}")(h, x, em, node_attr=h0 if self.node_attr else None)
        h = self.node_dec(h) * m[..., None]
        return self.graph_dec(h.sum(dim=1))[..., 0]


def load_reference_classifier(model_dir: str) -> EGNNClassifier:
    """The reference classifier directory (``args.pickle`` with ``nf``,
    ``n_layers``, ``attention``, ``node_attr``; ``best_checkpoint.npy``, a
    saved state_dict) -> an ``EGNNClassifier`` on the CPU, loaded strictly."""
    with open(os.path.join(model_dir, "args.pickle"), "rb") as f:
        args = pickle.load(f)
    model = EGNNClassifier(in_node_nf=5, hidden_nf=int(args.nf), n_layers=int(args.n_layers),
                           attention=bool(args.attention), node_attr=int(args.node_attr))
    state_dict = torch.load(os.path.join(model_dir, "best_checkpoint.npy"), map_location="cpu",
                            weights_only=False)
    model.load_state_dict(state_dict, strict=True)
    return model
