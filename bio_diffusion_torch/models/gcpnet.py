"""GCPNet denoiser over dense molecule batches.

Port of ``bio_diffusion_tpu/models/gcpnet.py`` (module tree and parameter
names: ``GCPEmbedding``, ``GCPMessagePassing``, ``GCPInteractions``,
``GCPNetDynamics``) with the packed forward of
``bio_diffusion_tpu/models/gcpnet_fast.py`` (``_featurize``, ``_build_epack``,
``_node_update``, ``_decode_outputs``, ``make_fast_dynamics`` and the
trainable ``fast_forward_trainable``): geometry in float32, the network body
in the compute dtype, and every message-passing layer through
:func:`bio_diffusion_torch.ops.message_layer.message_layer` (the CUDA kernels,
forward and backward, on CUDA tensors).

:func:`message_passing_unfused` is the counterpart of
``gcpnet_fast.py::_message_passing_fast``: the same layer with its first GCP
on materialized ``[B, N, N, .]`` tensors and its chain through the flat-edge
kernel (``ops/gcp2_chain.py``).  As in the JAX package, the denoiser's
forward does not take it.

The packed forward covers the configurations of ``supports_fast_path``
(GCP2 with vector gates, no norm/dropout/ablations, one feedforward GCP,
scalar message attention, residual message stack), with or without property
conditioning and self-conditioning.  Every other configuration takes the
module forward (JAX ``gcpnet.py``'s flax modules as PyTorch ops): GCP v1,
GCP2's frame and norm gates, vector residuals and ablations, GCP norm,
pre-norm and dropout, any message stack, any number of feedforward GCPs, the
vector-sum position update and every nonlinearity.  The choice is made from
the configuration when the denoiser is built, never at run time.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from bio_diffusion_torch.config.schema import (
    DataloaderConfig, DiffusionConfig, LayerConfig, ModelConfig, ModuleConfig,
    compute_num_atom_types,
)
from bio_diffusion_torch.models.gcp import make_gcp
from bio_diffusion_torch.models.gcp_fused import GCP2FusedEdgeMessage
from bio_diffusion_torch.models.nn import DropoutDraws, GCPDropout, GCPLayerNorm
from bio_diffusion_torch.ops.gcp2_chain import fused_gcp2_chain, gcp2_chain_plain
from bio_diffusion_torch.ops.geometry import (
    build_edge_mask, centralize, edge_features, localize, masked_sum, node_mean_frames, orientations,
)
from bio_diffusion_torch.ops.message_layer import (
    cast_parameters, detached, message_layer, message_layer_plain, pack_message_stack, stack_chain,
)
from bio_diffusion_torch.ops.scalar_vector import ScalarVector

Tensor = torch.Tensor


def supports_fast_path(module_cfg: ModuleConfig, layer_cfg: LayerConfig) -> bool:
    """The configurations the packed forward implements (``gcpnet_fast.py:59``)."""
    return (
        module_cfg.selected_gcp.lower() == "gcp2"
        and module_cfg.vector_gate
        and not module_cfg.frame_gate
        and not module_cfg.ablate_frame_updates
        and not module_cfg.ablate_scalars
        and not module_cfg.ablate_vectors
        and not module_cfg.update_positions_with_vector_sum
        and not layer_cfg.use_gcp_norm
        and not layer_cfg.use_gcp_dropout
        and not layer_cfg.pre_norm
        and layer_cfg.use_scalar_message_attention
        and layer_cfg.num_feedforward_layers == 1
        and layer_cfg.mp_cfg.use_residual_message_gcp
        and module_cfg.scalar_nonlinearity == "silu"
        and module_cfg.vector_nonlinearity == "silu"
        and not module_cfg.vector_residual
        and not module_cfg.default_vector_residual
    )


def uses_fused_first_message(module_cfg: ModuleConfig) -> bool:
    """Whether the first message GCP runs per part (``GCP2FusedEdgeMessage``)
    rather than on the materialized concat (JAX ``gcpnet.py:136-143``)."""
    return (
        module_cfg.selected_gcp.lower() == "gcp2"
        and not module_cfg.frame_gate
        and not module_cfg.ablate_frame_updates
        and not module_cfg.ablate_scalars
        and not module_cfg.ablate_vectors
        and not module_cfg.default_vector_residual
    )


def _apply(gcp: nn.Module, rep: ScalarVector, frames: Tensor) -> ScalarVector:
    """A GCP (coords-major inside) on a ScalarVector (``[..., V, 3]``); a
    module without vector outputs gives ``[..., 0, 3]`` vectors."""
    s, v_cm = gcp(rep.scalar, rep.vector_cm, frames)
    if v_cm is None:
        return ScalarVector(s, s.new_zeros(s.shape[:-1] + (0, 3)))
    return ScalarVector.from_cm(s, v_cm)


class GCPEmbedding(nn.Module):
    """One edge GCP and one node GCP, each input GCP-normed first (an identity
    without ``use_gcp_norm``; the denoiser always pre-norms its embedding)."""

    def __init__(self, edge_input_dims, node_input_dims, edge_hidden_dims, node_hidden_dims,
                 module_cfg: ModuleConfig, use_gcp_norm: bool = False):
        super().__init__()
        self.edge_normalization = GCPLayerNorm(edge_input_dims[0], use_gcp_norm)
        self.node_normalization = GCPLayerNorm(node_input_dims[0], use_gcp_norm)
        sel = module_cfg.selected_gcp
        self.edge_embedding = make_gcp(sel, edge_input_dims, edge_hidden_dims, module_cfg,
                                       nonlinearities=module_cfg.nonlinearities)
        self.node_embedding = make_gcp(sel, node_input_dims, node_hidden_dims, module_cfg,
                                       nonlinearities=(None, None))

    def forward(self, node_rep: ScalarVector, edge_rep: ScalarVector, edge_frames: Tensor,
                node_frames: Tensor) -> Tuple[ScalarVector, ScalarVector]:
        edge_rep, node_rep = self.edge_normalization(edge_rep), self.node_normalization(node_rep)
        return _apply(self.node_embedding, node_rep, node_frames), _apply(self.edge_embedding, edge_rep, edge_frames)


class GCPMessagePassing(nn.Module):
    """A stack of ``num_message_layers`` message GCPs over [node_i | edge_ij |
    node_j] on every edge (residual, or not), optional sigmoid scalar
    attention, and the masked sum over targets.  The packed forward runs it
    as one message-layer kernel; :meth:`forward` is the module path."""

    def __init__(self, node_dims, edge_dims, module_cfg: ModuleConfig, layer_cfg: LayerConfig):
        super().__init__()
        cfg, num = module_cfg, layer_cfg.mp_cfg.num_message_layers
        s, v = node_dims
        se, ve = edge_dims
        self.residual = layer_cfg.mp_cfg.use_residual_message_gcp
        self.fused = uses_fused_first_message(cfg)

        def primary(in_dims):
            return make_gcp(cfg.selected_gcp, in_dims, node_dims, cfg, bottleneck=cfg.default_bottleneck,
                            vector_residual=cfg.default_vector_residual)

        if self.fused:
            first = GCP2FusedEdgeMessage(node_dims, edge_dims, node_dims, cfg.nonlinearities,
                                         vector_gate=cfg.vector_gate, bottleneck=cfg.default_bottleneck)
        else:
            first = primary((2 * s + se, 2 * v + ve))
        fusion = [first] + [make_gcp(cfg.selected_gcp, node_dims, node_dims, cfg, bottleneck=cfg.bottleneck,
                                     vector_residual=cfg.vector_residual) for _ in range(num - 2)]
        if num > 1:
            fusion.append(primary(node_dims))
        self.message_fusion = nn.ModuleList(fusion)
        if layer_cfg.use_scalar_message_attention:
            self.scalar_message_attention = nn.Sequential(nn.Linear(s, 1), nn.Sigmoid())

    def forward(self, node_rep: ScalarVector, edge_rep: ScalarVector, edge_frames: Tensor,
                edge_mask: Tensor) -> ScalarVector:
        """Nodes ``[B, N, .]``, edges ``[B, N, N, .]`` -> the aggregated messages ``[B, N, .]``."""
        s, v_cm = node_rep.scalar, node_rep.vector_cm
        e, xi_cm = edge_rep.scalar, edge_rep.vector_cm
        if self.fused:
            ms, mv = self.message_fusion[0](s, v_cm, e, xi_cm, edge_frames)
        else:
            n = s.shape[-2]
            s_i = s[..., :, None, :].expand(*s.shape[:-2], n, n, s.shape[-1])
            v_i = v_cm[..., :, None, :, :].expand(*v_cm.shape[:-3], n, n, *v_cm.shape[-2:])
            ms, mv = self.message_fusion[0](
                torch.cat([s_i, e, s_i.transpose(-3, -2)], dim=-1),
                torch.cat([v_i, xi_cm, v_i.transpose(-4, -3)], dim=-1), edge_frames)
        for gcp in self.message_fusion[1:]:
            ds, dv = gcp(ms, mv, edge_frames)
            ms, mv = (ms + ds, mv + dv) if self.residual else (ds, dv)
        if hasattr(self, "scalar_message_attention"):
            lin = self.scalar_message_attention[0]
            ms = ms * torch.sigmoid(F.linear(ms, lin.weight.to(ms.dtype), lin.bias.to(ms.dtype)))
        # the masked sum over targets j
        return ScalarVector.from_cm(masked_sum(ms, edge_mask, dim=-2), masked_sum(mv, edge_mask, dim=-3))


class GCPInteractions(nn.Module):
    """One denoiser layer: message passing, the feedforward GCPs, GCP dropout
    and norm, the position update."""

    def __init__(self, node_dims, edge_dims, module_cfg: ModuleConfig, layer_cfg: LayerConfig,
                 dropout: float = 0.0):
        super().__init__()
        cfg, lc = module_cfg, layer_cfg
        s, v = node_dims
        sel = cfg.selected_gcp
        self.pre_norm = lc.pre_norm
        self.vector_sum = cfg.update_positions_with_vector_sum
        self.positions_weight = cfg.node_positions_weight
        self.gcp_norm = nn.ModuleList([GCPLayerNorm(s, lc.use_gcp_norm)])
        self.interaction = GCPMessagePassing(node_dims, edge_dims, cfg, lc)
        n_ff = lc.num_feedforward_layers
        hidden = node_dims if n_ff == 1 else (4 * s, 2 * v)
        ff = [make_gcp(sel, (2 * s, 2 * v), hidden, cfg, nonlinearities=(None, None) if n_ff == 1 else None,
                       bottleneck=cfg.bottleneck, vector_residual=False, feedforward_out=n_ff == 1)]
        ff += [make_gcp(sel, hidden, hidden, cfg, bottleneck=cfg.bottleneck) for _ in range(n_ff - 2)]
        if n_ff > 1:
            ff.append(make_gcp(sel, hidden, node_dims, cfg, nonlinearities=(None, None), bottleneck=cfg.bottleneck,
                               vector_residual=False, feedforward_out=True))
        self.feedforward_network = nn.ModuleList(ff)
        self.gcp_dropout = nn.ModuleList([GCPDropout(dropout, lc.use_gcp_dropout)])
        self.node_position_update_gcp = make_gcp(sel, node_dims, node_dims if self.vector_sum else (s, 1), cfg,
                                                 bottleneck=cfg.bottleneck, vector_residual=False)

    def forward(self, node_rep: ScalarVector, edge_rep: ScalarVector, edge_frames: Tensor, node_frames: Tensor,
                node_mask: Tensor, edge_mask: Tensor, node_pos: Tensor,
                dropout: Optional[DropoutDraws] = None) -> Tuple[ScalarVector, Tensor]:
        norm = self.gcp_norm[0]
        if self.pre_norm:
            node_rep = norm(node_rep)
        hidden = self.interaction(node_rep, edge_rep, edge_frames, edge_mask).concat(node_rep)
        for gcp in self.feedforward_network:
            hidden = _apply(gcp, hidden, node_frames)
        node_rep = node_rep + self.gcp_dropout[0](hidden, dropout)
        if not self.pre_norm:
            node_rep = norm(node_rep)
        node_rep = node_rep.mask(node_mask)
        _, v_cm = self.node_position_update_gcp(node_rep.scalar, node_rep.vector_cm, node_frames)
        update = v_cm.sum(dim=-1) if self.vector_sum else v_cm[..., 0]
        node_pos = node_pos + update * self.positions_weight
        return node_rep, node_pos * node_mask[..., None].to(node_pos.dtype)


class GCPNetDynamics(nn.Module):
    """eps-prediction denoiser: ``(xh [B, N, 3+F], t [B, 1], node_mask [B, N],
    context [B, N, C] or None, xh_self_cond [B, N, 3+F] or None) -> [B, N,
    3+F]`` (CoM-free velocity | eps_h), float32 out.  A model conditioned on
    C properties (``module_cfg.conditioning``) takes their per-node context
    as C more node input scalars and requires it.  A self-conditioned model
    (``diffusion_cfg.self_condition``) featurizes ``xh_self_cond`` (zeros
    where None) as it does ``xh``, on the same masks, and appends each block
    after the noisy input's own: h on the scalars, the orientations on the
    vectors, the edge features on the edges.  Only the embeddings' input
    widths change, not the message layers'.

    Two forwards over one module tree: the packed forward (the message-layer
    kernels) where ``supports_fast_path`` holds and ``fast`` is not "off",
    else the module forward (GCPs as ordinary PyTorch ops, every option of
    the reference).  The choice is made once, here, and kept in
    :attr:`packed`.  ``fast`` is ``trainer.fast_train``: "on" or "pallas"
    for a configuration the packed forward does not implement raise
    ``ValueError``.

    ``compute_dtype`` ("bfloat16" or None) is the network body's dtype.  With
    gradients enabled (training) the packed forward packs the live
    parameters on every call, so gradients reach them; without (serving,
    evaluation) it reads a detached packed copy, rebuilt whenever a
    parameter changed (the copy is keyed on the parameters' version
    counters, which every in-place update bumps: optimizer steps, EMA
    updates, ``load_state_dict``).  ``dropout`` (the training loss's draws)
    applies GCP dropout on the module forward; without it the forward is
    deterministic.

    ``use_kernels=False`` runs the packed forward's message layers through
    their plain PyTorch version (``message_layer_plain``, autograd for the
    backward) on any device, the JAX package's ``use_pallas=False``: for
    comparison and measurement (``cli/bench_train_step.py``'s ``plain``
    path); no entry point of the main path sets it."""

    def __init__(self, model_cfg: ModelConfig, module_cfg: ModuleConfig, layer_cfg: LayerConfig,
                 diffusion_cfg: DiffusionConfig, dataloader_cfg: DataloaderConfig,
                 compute_dtype: Optional[str] = None, fast: str = "auto", use_kernels: bool = True):
        super().__init__()
        self.use_kernels = use_kernels
        supported = supports_fast_path(module_cfg, layer_cfg)
        if fast in ("on", "pallas") and not supported:
            raise ValueError(f"trainer.fast_train={fast} but the model config is not supported by the fast path")
        self.packed = supported and fast != "off"
        self.model_cfg, self.module_cfg, self.layer_cfg = model_cfg, module_cfg, layer_cfg
        self.diffusion_cfg, self.dataloader_cfg = diffusion_cfg, dataloader_cfg
        self.compute_dtype = {None: torch.float32, "bfloat16": torch.bfloat16}[compute_dtype]
        mc = model_cfg
        h_in = compute_num_atom_types(dataloader_cfg) + int(dataloader_cfg.include_charges)
        # node scalars in: [atom types | charges if any | (self-conditioning:
        # the same of the estimate) | time | context]; self-conditioning
        # doubles every input block (JAX ``_input_dims``)
        self.num_context = len(module_cfg.conditioning)
        h_cond = int(diffusion_cfg.condition_on_time) + self.num_context
        k = 2 if diffusion_cfg.self_condition else 1
        node_dims = (mc.h_hidden_dim, mc.chi_hidden_dim)
        edge_dims = (mc.e_hidden_dim, mc.xi_hidden_dim)
        self.gcp_embedding = GCPEmbedding(
            (k * mc.e_input_dim, k * mc.xi_input_dim), (k * h_in + h_cond, k * mc.chi_input_dim),
            edge_dims, node_dims, module_cfg, use_gcp_norm=layer_cfg.use_gcp_norm,
        )
        self.interaction_layers = nn.ModuleList([
            GCPInteractions(node_dims, edge_dims, module_cfg, layer_cfg, dropout=mc.dropout)
            for _ in range(mc.num_encoder_layers)
        ])
        self.scalar_node_projection_gcp = make_gcp(module_cfg.selected_gcp, node_dims, (h_in + h_cond, 0),
                                                   module_cfg, nonlinearities=(None, None))
        self._packed: Optional[Dict[str, Any]] = None
        self._packed_key: Optional[tuple] = None

    def _apply(self, fn, *args, **kwargs):
        # moving or casting replaces the parameters' data without bumping
        # their version counters
        self.drop_weight_cache()
        return super()._apply(fn, *args, **kwargs)

    def drop_weight_cache(self) -> None:
        """Forget :meth:`packed_weights` (e.g. when the parameters' storage is released)."""
        self._packed = None

    def weights(self) -> Dict[str, Any]:
        """Every weight in the compute dtype, message layers packed for the
        kernels; built from the live parameters (differentiable)."""
        cdt, mc = self.compute_dtype, self.model_cfg
        layers = []
        for layer in self.interaction_layers:
            g1, chain = pack_message_stack(layer.interaction, mc.h_hidden_dim, mc.chi_hidden_dim,
                                           mc.xi_hidden_dim, cdt)
            layers.append({
                "g1": g1,
                "chain": chain,
                "ff": cast_parameters(layer.feedforward_network[0], cdt),
                "pos": cast_parameters(layer.node_position_update_gcp, cdt),
            })
        return {
            "edge": cast_parameters(self.gcp_embedding.edge_embedding, cdt),
            "node": cast_parameters(self.gcp_embedding.node_embedding, cdt),
            "layers": layers,
            "proj": cast_parameters(self.scalar_node_projection_gcp, cdt),
        }

    def packed_weights(self) -> Dict[str, Any]:
        """:meth:`weights` detached and contiguous, cached until a parameter changes."""
        key = tuple(p._version for p in self.parameters())
        if self._packed is None or self._packed_key != key:
            with torch.no_grad():
                self._packed = detached(self.weights())
            self._packed_key = key
        return self._packed

    def _featurize(self, xh: Tensor, t: Tensor, node_mask: Tensor, context: Optional[Tensor],
                   xh_self_cond: Optional[Tensor]) -> Dict[str, Tensor]:
        """The float32 geometry and the input features both forwards start from."""
        nx = self.dataloader_cfg.num_x_dims
        b, n = node_mask.shape
        mask_f = node_mask.to(xh.dtype)
        xh = xh * mask_f[..., None]
        x_init, h = xh[..., :nx], xh[..., nx:]
        edge_mask = build_edge_mask(node_mask)
        chi = orientations(x_init, node_mask)  # [B, N, 2, 3]
        e_s, e_v = edge_features(x_init, edge_mask)  # [B, N, N, 1], [B, N, N, 1, 3]
        if self.diffusion_cfg.self_condition:
            sc = torch.zeros_like(xh) if xh_self_cond is None else xh_self_cond.to(xh.dtype)
            e_s_sc, e_v_sc = edge_features(sc[..., :nx], edge_mask)
            h = torch.cat([h, sc[..., nx:]], dim=-1)
            chi = torch.cat([chi, orientations(sc[..., :nx], node_mask)], dim=-2)
            e_s = torch.cat([e_s, e_s_sc], dim=-1)
            e_v = torch.cat([e_v, e_v_sc], dim=-2)
        if self.diffusion_cfg.condition_on_time:
            h = torch.cat([h, t[:, None, :].expand(b, n, t.shape[-1]).to(h.dtype)], dim=-1)
        if self.num_context:
            h = torch.cat([h, context.to(h.dtype)], dim=-1)
        _, x_cent = centralize(x_init, node_mask)
        f_ij = localize(x_cent, edge_mask, norm_x_diff=self.module_cfg.norm_x_diff)
        return dict(mask_f=mask_f, x_init=x_init, h=h, chi=chi, e_s=e_s, e_v=e_v, edge_mask=edge_mask,
                    x_cent=x_cent, f_ij=f_ij, f_node=node_mean_frames(f_ij, edge_mask))

    def forward(self, xh: Tensor, t: Tensor, node_mask: Tensor, context: Optional[Tensor] = None,
                xh_self_cond: Optional[Tensor] = None, dropout: Optional[DropoutDraws] = None) -> Tensor:
        if self.num_context and context is None:
            raise ValueError("a property-conditioned model requires a context tensor")
        f = self._featurize(xh, t, node_mask, context, xh_self_cond)
        body = self._packed_body if self.packed else self._module_body
        x, h_out = body(f, node_mask, dropout)

        # ---- outputs ----
        mask_f = f["mask_f"]
        vel = (x - f["x_init"]) * mask_f[..., None]
        # strip the context columns first, then the time column
        h_out = h_out.float()[..., :h_out.shape[-1] - self.num_context]
        if self.diffusion_cfg.condition_on_time:
            h_out = h_out[..., :-1]
        # a non-finite velocity anywhere zeroes the whole batch's velocity
        vel = torch.where(torch.isfinite(vel).all(), vel, torch.zeros_like(vel))
        _, vel = centralize(vel, node_mask)
        return torch.cat([vel, h_out], dim=-1)

    def _module_body(self, f: Dict[str, Tensor], node_mask: Tensor,
                     dropout: Optional[DropoutDraws]) -> Tuple[Tensor, Tensor]:
        """GCPNet as modules (JAX ``GCPNetDynamics.__call__``) -> (positions, h)."""
        cdt = self.compute_dtype
        f_ij, f_node = f["f_ij"].to(cdt), f["f_node"].to(cdt)
        node_rep, edge_rep = self.gcp_embedding(
            ScalarVector(f["h"].to(cdt), f["chi"].to(cdt)), ScalarVector(f["e_s"].to(cdt), f["e_v"].to(cdt)),
            f_ij, f_node)
        x = f["x_cent"]
        for layer in self.interaction_layers:
            node_rep, x = layer(node_rep, edge_rep, f_ij, f_node, node_mask, f["edge_mask"], x, dropout)
        h_out, _ = self.scalar_node_projection_gcp(node_rep.scalar, node_rep.vector_cm, f_node)
        return x, h_out

    def _packed_body(self, f: Dict[str, Tensor], node_mask: Tensor, dropout=None) -> Tuple[Tensor, Tensor]:
        """The packed forward (JAX ``gcpnet_fast.py``): the message layers
        through the kernels -> (positions, h).  No configuration it takes has
        dropout."""
        mc, cdt = self.model_cfg, self.compute_dtype
        w = self.weights() if torch.is_grad_enabled() else self.packed_weights()
        b, n = node_mask.shape
        v_dim, ve_dim = mc.chi_hidden_dim, mc.xi_hidden_dim
        f_ij, mask_f, edge_mask = f["f_ij"], f["mask_f"], f["edge_mask"]
        f_node_c = f["f_node"].to(cdt)
        # transposed frames flattened k*3+a: the kernel's layout
        frames_t = f_ij.transpose(-1, -2).reshape(b, n, n, 9).to(cdt)

        # ---- embeddings (compute dtype) ----
        e_emb, xi_emb = self.gcp_embedding.edge_embedding(
            f["e_s"].to(cdt), f["e_v"].transpose(-1, -2).to(cdt), f_ij.to(cdt), weights=w["edge"])
        s_node, v_node = self.gcp_embedding.node_embedding(
            f["h"].to(cdt), f["chi"].transpose(-1, -2).to(cdt), f_node_c, weights=w["node"])

        # ---- packed edge tensor [B, N*N, Se + 3Ve + 10] ----
        epack = torch.cat([
            e_emb, xi_emb.reshape(b, n, n, 3 * ve_dim), frames_t, edge_mask[..., None].to(cdt),
        ], dim=-1).reshape(b, n * n, -1)
        # the layers read only the packed tensor: its pieces would otherwise
        # stay resident through every layer (two fifths of its size again)
        del e_emb, xi_emb, frames_t

        x = f["x_cent"]
        node_m = mask_f[..., None].to(cdt)
        layer_fn = message_layer if self.use_kernels else message_layer_plain
        for layer, lw in zip(self.interaction_layers, w["layers"]):
            s_agg, v_agg = layer_fn(
                s_node, v_node.reshape(b, n, 3 * v_dim), epack, lw["g1"], lw["chain"], ve_dim=ve_dim)
            s_ff, v_ff = layer.feedforward_network[0](
                torch.cat([s_agg, s_node], dim=-1),
                torch.cat([v_agg.reshape(b, n, 3, v_dim), v_node], dim=-1),
                f_node_c, weights=lw["ff"])
            s_node = (s_node + s_ff) * node_m
            v_node = (v_node + v_ff) * node_m[..., None]
            _, v_pu = layer.node_position_update_gcp(s_node, v_node, f_node_c, weights=lw["pos"])
            x = (x + v_pu[..., :, 0].float() * self.module_cfg.node_positions_weight) * mask_f[..., None]

        h_out, _ = self.scalar_node_projection_gcp(s_node, v_node, f_node_c, weights=w["proj"])
        return x, h_out


def stack_chain_weights(mp: GCPMessagePassing, dtype) -> Tuple[Tensor, ...]:
    """A message stack's residual chain and attention weights cast to
    ``dtype``, stacked as ``fused_gcp2_chain`` takes them: ``(wd, wdf, ws, bs,
    wu, wg, bg, wattn, battn)`` (counterpart of
    ``gcpnet_fast.py::_stack_chain_weights``)."""
    return stack_chain([cast_parameters(g, dtype) for g in mp.message_fusion[1:]],
                       cast_parameters(mp.scalar_message_attention[0], dtype))


def message_passing_unfused(mp: GCPMessagePassing, s_node: Tensor, v_node_cm: Tensor, e: Tensor,
                            xi_cm: Tensor, frames_flat: Tensor, edge_mask: Tensor,
                            use_kernel: bool = True) -> Tuple[Tensor, Tensor]:
    """One message stack over materialized edge tensors -> aggregated
    ``(s [B, N, S], v_cm [B, N, 3, V])``, the unfused route to what
    :func:`bio_diffusion_torch.ops.message_layer.message_layer` computes in one
    kernel (counterpart of ``gcpnet_fast.py::_message_passing_fast``).

    ``s_node [B, N, S]``, ``v_node_cm [B, N, 3, V]``, ``e [B, N, N, Se]``,
    ``xi_cm [B, N, N, 3, Ve]``, ``frames_flat [B*N*N, 9]`` (transposed,
    k*3+a), ``edge_mask [B, N, N]``; the compute dtype is ``s_node``'s.  The
    first GCP is a split-weight evaluation on ``[B, N, N, .]`` tensors
    (``torch.matmul``); the residual chain and the attention run over flat
    edge rows through :func:`fused_gcp2_chain` (the CUDA kernel on CUDA
    tensors), or through its plain version without ``use_kernel``; the last
    step is the masked sum over targets."""
    dt = s_node.dtype
    b, n, s_dim = s_node.shape
    v_dim, ve_dim, se_dim = v_node_cm.shape[-1], xi_cm.shape[-1], e.shape[-1]
    w1 = cast_parameters(mp.message_fusion[0], dt)

    # ---- first GCP: split-weight evaluation ----
    wd = w1["vector_down.weight"].t()  # [2V+Ve, H]
    wdf = w1["vector_down_frames.weight"].t()  # [2V+Ve, 3]

    def split_v(w):  # (v_i, xi_ij, v_j) parts of a vector projection -> [B, N, N, 3, .]
        return ((v_node_cm @ w[:v_dim])[:, :, None] + xi_cm @ w[v_dim:v_dim + ve_dim]
                + (v_node_cm @ w[v_dim + ve_dim:])[:, None, :])

    vh = split_v(wd)
    vnorm = torch.sqrt((vh * vh).sum(dim=-2) + 1e-8) + 1e-8
    frames4_t = frames_flat.reshape(b, n, n, 3, 3).to(dt)  # [..., k, a]
    sc = torch.einsum("...ka,...kc->...ca", frames4_t, split_v(wdf)).reshape(b, n, n, 9)
    ws = w1["scalar_out.weight"].t()
    h_dim = vh.shape[-1]
    s2 = (
        (s_node @ ws[:s_dim])[:, :, None]
        + e @ ws[s_dim:s_dim + se_dim]
        + (s_node @ ws[s_dim + se_dim:2 * s_dim + se_dim])[:, None, :]
        + vnorm.to(dt) @ ws[2 * s_dim + se_dim:2 * s_dim + se_dim + h_dim]
        + sc @ ws[2 * s_dim + se_dim + h_dim:]
        + w1["scalar_out.bias"]
    )
    s1 = F.silu(s2)
    gate = torch.sigmoid(s1 @ w1["vector_out_scale.weight"].t() + w1["vector_out_scale.bias"])
    v1 = (vh @ w1["vector_up.weight"].t()) * gate[..., None, :]  # [B, N, N, 3, V]

    # ---- residual chain + attention over flat edge rows ----
    e_count = b * n * n
    chain = (s1.reshape(e_count, s_dim), v1.reshape(e_count, 3 * v_dim), frames_flat.to(dt),
             *stack_chain_weights(mp, dt))
    s_out, v_out = fused_gcp2_chain(*chain) if use_kernel else gcp2_chain_plain(*chain)

    # ---- masked aggregation over targets j ----
    em = edge_mask.to(dt)
    s_agg = (s_out.reshape(b, n, n, s_dim) * em[..., None]).sum(dim=2)
    v_agg = (v_out.reshape(b, n, n, 3, v_dim) * em[..., None, None]).sum(dim=2)
    return s_agg, v_agg
