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

The port covers the configuration the fast path supports (GCP2 with vector
gates, no norm/dropout/ablations, one feedforward GCP, scalar message
attention, residual message stack), with or without property conditioning
and self-conditioning; ``GCPNetDynamics`` raises ``NotImplementedError``
for anything else.
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
from bio_diffusion_torch.models.gcp import GCP2
from bio_diffusion_torch.ops.gcp2_chain import fused_gcp2_chain, gcp2_chain_plain
from bio_diffusion_torch.ops.geometry import (
    build_edge_mask, centralize, edge_features, localize, node_mean_frames, orientations,
)
from bio_diffusion_torch.ops.message_layer import (
    cast_parameters, detached, message_layer, pack_message_stack, stack_chain,
)

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


class GCPEmbedding(nn.Module):
    """One edge GCP and one node GCP (the GCP norms are identities here)."""

    def __init__(self, edge_input_dims, node_input_dims, edge_hidden_dims, node_hidden_dims,
                 module_cfg: ModuleConfig):
        super().__init__()
        self.edge_embedding = GCP2(edge_input_dims, edge_hidden_dims, module_cfg.nonlinearities)
        self.node_embedding = GCP2(node_input_dims, node_hidden_dims, (None, None))


class GCPMessagePassing(nn.Module):
    """Residual stack of message GCPs over [node_i | edge_ij | node_j] plus
    sigmoid scalar attention; the forward is the packed message layer."""

    def __init__(self, node_dims, edge_dims, module_cfg: ModuleConfig, layer_cfg: LayerConfig):
        super().__init__()
        s, v = node_dims
        se, ve = edge_dims
        nl = module_cfg.nonlinearities
        num = layer_cfg.mp_cfg.num_message_layers
        fusion = [GCP2((2 * s + se, 2 * v + ve), node_dims, nl, bottleneck=module_cfg.default_bottleneck)]
        fusion += [GCP2(node_dims, node_dims, nl, bottleneck=module_cfg.bottleneck)
                   for _ in range(num - 2)]
        if num > 1:
            fusion.append(GCP2(node_dims, node_dims, nl, bottleneck=module_cfg.default_bottleneck))
        self.message_fusion = nn.ModuleList(fusion)
        self.scalar_message_attention = nn.Sequential(nn.Linear(s, 1), nn.Sigmoid())


class GCPInteractions(nn.Module):
    """One denoiser layer: message passing, feedforward GCP, position update."""

    def __init__(self, node_dims, edge_dims, module_cfg: ModuleConfig, layer_cfg: LayerConfig):
        super().__init__()
        s, v = node_dims
        self.interaction = GCPMessagePassing(node_dims, edge_dims, module_cfg, layer_cfg)
        self.feedforward_network = nn.ModuleList([
            GCP2((2 * s, 2 * v), node_dims, (None, None), feedforward_out=True,
                 bottleneck=module_cfg.bottleneck)
        ])
        self.node_position_update_gcp = GCP2(node_dims, (s, 1), module_cfg.nonlinearities,
                                             bottleneck=module_cfg.bottleneck)


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

    ``compute_dtype`` ("bfloat16" or None) is the network body's dtype.  With
    gradients enabled (training) the forward packs the live parameters on
    every call, so gradients reach them; without (serving, evaluation) it
    reads a detached packed copy, rebuilt whenever a parameter changed (the
    copy is keyed on the parameters' version counters, which every in-place
    update bumps: optimizer steps, EMA updates, ``load_state_dict``)."""

    def __init__(self, model_cfg: ModelConfig, module_cfg: ModuleConfig, layer_cfg: LayerConfig,
                 diffusion_cfg: DiffusionConfig, dataloader_cfg: DataloaderConfig,
                 compute_dtype: Optional[str] = None):
        super().__init__()
        if not supports_fast_path(module_cfg, layer_cfg):
            raise NotImplementedError("GCPNet configuration outside the port's packed forward")
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
            edge_dims, node_dims, module_cfg,
        )
        self.interaction_layers = nn.ModuleList([
            GCPInteractions(node_dims, edge_dims, module_cfg, layer_cfg)
            for _ in range(mc.num_encoder_layers)
        ])
        self.scalar_node_projection_gcp = GCP2(node_dims, (h_in + h_cond, 0), (None, None))
        self._packed: Optional[Dict[str, Any]] = None
        self._packed_key: Optional[tuple] = None

    def _apply(self, fn, *args, **kwargs):
        # moving or casting replaces the parameters' data without bumping
        # their version counters
        self._packed = None
        return super()._apply(fn, *args, **kwargs)

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

    def forward(self, xh: Tensor, t: Tensor, node_mask: Tensor, context: Optional[Tensor] = None,
                xh_self_cond: Optional[Tensor] = None) -> Tensor:
        if self.num_context and context is None:
            raise ValueError("a property-conditioned model requires a context tensor")
        mc, dl = self.model_cfg, self.dataloader_cfg
        cdt = self.compute_dtype
        w = self.weights() if torch.is_grad_enabled() else self.packed_weights()
        nx = dl.num_x_dims
        b, n = node_mask.shape
        v_dim, ve_dim = mc.chi_hidden_dim, mc.xi_hidden_dim

        # ---- featurization (float32 geometry) ----
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
        f_node_c = node_mean_frames(f_ij, edge_mask).to(cdt)
        # transposed frames flattened k*3+a: the kernel's layout
        frames_t = f_ij.transpose(-1, -2).reshape(b, n, n, 9).to(cdt)

        # ---- embeddings (compute dtype) ----
        e_emb, xi_emb = self.gcp_embedding.edge_embedding(
            e_s.to(cdt), e_v.transpose(-1, -2).to(cdt), f_ij.to(cdt), weights=w["edge"])
        s_node, v_node = self.gcp_embedding.node_embedding(
            h.to(cdt), chi.transpose(-1, -2).to(cdt), f_node_c, weights=w["node"])

        # ---- packed edge tensor [B, N*N, Se + 3Ve + 10] ----
        epack = torch.cat([
            e_emb, xi_emb.reshape(b, n, n, 3 * ve_dim), frames_t, edge_mask[..., None].to(cdt),
        ], dim=-1).reshape(b, n * n, -1)

        x = x_cent
        node_m = mask_f[..., None].to(cdt)
        for layer, lw in zip(self.interaction_layers, w["layers"]):
            s_agg, v_agg = message_layer(
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
        h_out = h_out.float()

        # ---- outputs ----
        vel = (x - x_init) * mask_f[..., None]
        # strip the context columns first, then the time column
        h_out = h_out[..., :h_out.shape[-1] - self.num_context]
        if self.diffusion_cfg.condition_on_time:
            h_out = h_out[..., :-1]
        # a non-finite velocity anywhere zeroes the whole batch's velocity
        vel = torch.where(torch.isfinite(vel).all(), vel, torch.zeros_like(vel))
        _, vel = centralize(vel, node_mask)
        return torch.cat([vel, h_out], dim=-1)


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
