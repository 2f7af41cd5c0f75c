"""The EGNN ablation denoiser over dense molecule batches.

Port of ``bio_diffusion_tpu/models/egnn.py`` (the reference's
``EGNNDynamics`` over its ``EGNN_Sparse`` layers, selected by
``diffusion_cfg.dynamics_network=egnn``): per-edge MLPs on ``[B, N, N, .]``
tensors with masked sums over targets, the fully connected graph with
self-loops.  Parameter names are the reference's: ``node_embedding``,
``edge_embedding``, ``egnn.mpnn_layers.<i>.{edge_mlp,coors_mlp,node_mlp}.{0,3}``,
``...coors_norm.scale``, ``...node_norm.{weight,bias}`` and
``scalar_node_projection``.

The dtypes follow the JAX module: with ``compute_dtype`` bfloat16 the inputs
and the three plain Linears (``node_embedding``, ``edge_embedding``,
``scalar_node_projection``, which cast their weights to the input) run in
bfloat16, while the MLP layers (:class:`XavierLinear`, flax ``nn.Dense``)
compute in the promotion of their input with their float32 weights.
``CoorsNorm`` gives 0 for a zero relative position (every self-loop), as
the reference and the JAX module do, and passes no gradient through it: the
JAX module's ``sqrt`` of the squared norm gives NaN there (0 x inf), the
reference's ``coors / coors.norm().clamp(eps)`` passes scale/eps (1e6 times
the cotangent), which the two ends of the self-loop cancel only up to
float32 rounding.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from bio_diffusion_torch.config.schema import (
    DataloaderConfig, DiffusionConfig, LayerConfig, ModelConfig, ModuleConfig, compute_num_atom_types,
)
from bio_diffusion_torch.models.nn import DropoutDraws
from bio_diffusion_torch.ops.geometry import build_edge_mask, centralize, edge_features, masked_sum

Tensor = torch.Tensor


def _linear_as_input(lin: nn.Linear, x: Tensor) -> Tensor:
    """A Linear with its weights cast to the input's dtype (JAX ``Linear``)."""
    return F.linear(x, lin.weight.to(x.dtype), lin.bias.to(x.dtype))


class XavierLinear(nn.Linear):
    """A Linear the reference initializes xavier-normal with a zero bias
    (``EGNN_Sparse.init_``), computing in the promoted dtype of its input
    and weights, as flax's ``nn.Dense`` does."""

    def forward(self, x: Tensor) -> Tensor:
        dt = torch.promote_types(x.dtype, self.weight.dtype)
        return F.linear(x.to(dt), self.weight.to(dt), None if self.bias is None else self.bias.to(dt))


def _mlp(sizes, silu_out: bool = False) -> nn.Sequential:
    """``Linear, (dropout), SiLU, Linear[, SiLU]``: the reference's Sequential
    indices, its Linears at 0 and 3."""
    layers = [XavierLinear(sizes[0], sizes[1]), nn.Identity(), nn.SiLU(), XavierLinear(sizes[1], sizes[2])]
    return nn.Sequential(*(layers + [nn.SiLU()] if silu_out else layers))


class CoorsNorm(nn.Module):
    """``coors / max(|coors|, eps) * scale``, ``scale`` initialized to 1e-2;
    a zero vector gives 0 and no gradient (see the module's docstring)."""

    eps, scale_init = 1e-8, 1e-2

    def __init__(self):
        super().__init__()
        self.scale = nn.Parameter(torch.full((1,), self.scale_init))

    def forward(self, coors: Tensor) -> Tensor:
        norm = torch.linalg.vector_norm(coors, dim=-1, keepdim=True)
        normed = torch.where(norm > 0, coors / torch.clamp(norm, min=self.eps), torch.zeros_like(coors))
        return normed * self.scale


class GraphLayerNorm(nn.Module):
    """pyg's ``LayerNorm(mode='graph')``: statistics over all nodes and
    channels of a graph, its padded rows included (the reference's flat
    batches hold them), eps 1e-5."""

    eps = 1e-5

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: Tensor) -> Tensor:  # [B, N, F]
        mean = x.mean(dim=(-1, -2), keepdim=True)
        var = ((x - mean) ** 2).mean(dim=(-1, -2), keepdim=True)
        return (x - mean) / torch.sqrt(var + self.eps) * self.weight + self.bias


class EGNNSparseLayer(nn.Module):
    """One EGNN message-passing layer (reference ``EGNN_Sparse``)."""

    m_dim = 16  # the message width (the reference's default)

    def __init__(self, feats_dim: int, edge_attr_dim: int):
        super().__init__()
        edge_input_dim, m_dim = 2 * feats_dim + edge_attr_dim + 1, self.m_dim
        self.edge_mlp = _mlp((edge_input_dim, 2 * edge_input_dim, m_dim), silu_out=True)
        self.coors_norm = CoorsNorm()
        self.coors_mlp = _mlp((m_dim, 4 * m_dim, 1))
        self.node_norm = GraphLayerNorm(feats_dim)
        self.node_mlp = _mlp((feats_dim + m_dim, 2 * feats_dim, feats_dim))

    def forward(self, x: Tensor, feats: Tensor, edge_attr: Tensor, edge_mask: Tensor) -> Tuple[Tensor, Tensor]:
        """``x [B, N, 3]``, ``feats [B, N, F]``, ``edge_attr [B, N, N, E]``,
        ``edge_mask [B, N, N]`` -> updated ``(x, feats)``."""
        b, n, f = feats.shape
        rel_coors = x[:, :, None, :] - x[:, None, :, :]
        rel_dist = torch.sum(rel_coors ** 2, dim=-1, keepdim=True)
        m_in = torch.cat([feats[:, :, None].expand(b, n, n, f), feats[:, None].expand(b, n, n, f),
                          edge_attr, rel_dist], dim=-1)
        m_ij = self.edge_mlp(m_in)
        coor_wij = torch.tanh(self.coors_mlp(m_ij))
        x_out = x + masked_sum(coor_wij * self.coors_norm(rel_coors), edge_mask, dim=-2)
        m_i = masked_sum(m_ij, edge_mask, dim=-2)
        feats_out = feats + self.node_mlp(torch.cat([self.node_norm(feats), m_i], dim=-1))
        return x_out, feats_out


class EGNNDynamics(nn.Module):
    """eps-prediction denoiser with the EGNN backbone, the call of
    ``GCPNetDynamics`` (``dropout`` is accepted and unused: the network has
    none)."""

    packed = False

    def __init__(self, model_cfg: ModelConfig, module_cfg: ModuleConfig, layer_cfg: LayerConfig,
                 diffusion_cfg: DiffusionConfig, dataloader_cfg: DataloaderConfig,
                 compute_dtype: Optional[str] = None):
        super().__init__()
        self.model_cfg, self.module_cfg, self.layer_cfg = model_cfg, module_cfg, layer_cfg
        self.diffusion_cfg, self.dataloader_cfg = diffusion_cfg, dataloader_cfg
        self.compute_dtype = {None: torch.float32, "bfloat16": torch.bfloat16}[compute_dtype]
        mc, dc = model_cfg, diffusion_cfg
        self.num_context = len(module_cfg.conditioning)
        self.h_in = compute_num_atom_types(dataloader_cfg) + int(dataloader_cfg.include_charges)
        h_cond = int(dc.condition_on_time) + self.num_context
        k = 2 if dc.self_condition else 1
        self.node_embedding = nn.Linear(k * self.h_in + h_cond, mc.h_hidden_dim)
        self.edge_embedding = nn.Linear(k, mc.e_hidden_dim)
        self.egnn = nn.Module()  # the layer stack under the reference's egnn.mpnn_layers names
        self.egnn.mpnn_layers = nn.ModuleList([EGNNSparseLayer(mc.h_hidden_dim, mc.e_hidden_dim)
                                               for _ in range(mc.num_encoder_layers)])
        self.scalar_node_projection = nn.Linear(mc.h_hidden_dim, self.h_in + h_cond)

    def forward(self, xh: Tensor, t: Tensor, node_mask: Tensor, context: Optional[Tensor] = None,
                xh_self_cond: Optional[Tensor] = None, dropout: Optional[DropoutDraws] = None) -> Tensor:
        if self.num_context and context is None:
            raise ValueError("a property-conditioned model requires a context tensor")
        dc, nx = self.diffusion_cfg, self.dataloader_cfg.num_x_dims
        b, n = node_mask.shape
        mask_f = node_mask.to(xh.dtype)
        xh = xh * mask_f[..., None]
        x_init, h = xh[..., :nx], xh[..., nx:]
        edge_mask = build_edge_mask(node_mask)
        e_s, _ = edge_features(x_init, edge_mask)
        if dc.self_condition:
            sc = torch.zeros_like(xh) if xh_self_cond is None else xh_self_cond.to(xh.dtype)
            h = torch.cat([h, sc[..., nx:]], dim=-1)
            e_s = torch.cat([e_s, edge_features(sc[..., :nx], edge_mask)[0]], dim=-1)
        if dc.condition_on_time:
            h = torch.cat([h, t[:, None, :].expand(b, n, t.shape[-1]).to(h.dtype)], dim=-1)
        if self.num_context:
            h = torch.cat([h, context.to(h.dtype)], dim=-1)
        _, x = centralize(x_init, node_mask)
        cdt = self.compute_dtype
        h, e_s, x = h.to(cdt), e_s.to(cdt), x.to(cdt)

        h = _linear_as_input(self.node_embedding, h) * mask_f[..., None].to(h.dtype)
        e = _linear_as_input(self.edge_embedding, e_s)
        for layer in self.egnn.mpnn_layers:
            x, h = layer(x, h, e, edge_mask)

        x = x.float() * mask_f[..., None]
        h = h * mask_f[..., None].to(h.dtype)
        h = _linear_as_input(self.scalar_node_projection, h).float() * mask_f[..., None]
        vel = (x - x_init) * mask_f[..., None]
        h = h[..., :h.shape[-1] - self.num_context]
        if dc.condition_on_time:
            h = h[..., :-1]
        vel = torch.where(torch.isfinite(vel).all(), vel, torch.zeros_like(vel))
        _, vel = centralize(vel, node_mask)
        return torch.cat([vel, h], dim=-1)
