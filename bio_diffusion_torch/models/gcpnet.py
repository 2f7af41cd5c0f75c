"""GCPNet denoiser over dense molecule batches.

Port of ``bio_diffusion_tpu/models/gcpnet.py`` (module tree and parameter
names: ``GCPEmbedding``, ``GCPMessagePassing``, ``GCPInteractions``,
``GCPNetDynamics``) with the packed forward of
``bio_diffusion_tpu/models/gcpnet_fast.py`` (``_featurize``, ``_build_epack``,
``_node_update``, ``_decode_outputs``, ``make_fast_dynamics``): geometry in
float32, the network body in the compute dtype, and every message-passing
layer through :func:`bio_diffusion_torch.ops.message_layer.fused_message_layer`
(the CUDA kernel on CUDA tensors).

The port covers the configuration the fast path supports (GCP2 with vector
gates, no norm/dropout/ablations, one feedforward GCP, scalar message
attention, residual message stack); ``GCPNetDynamics`` raises
``NotImplementedError`` for anything else.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from bio_diffusion_tpu.config.schema import (
    DataloaderConfig, DiffusionConfig, LayerConfig, ModelConfig, ModuleConfig,
    compute_num_atom_types,
)
from bio_diffusion_torch.models.gcp import GCP2
from bio_diffusion_torch.ops.geometry import (
    build_edge_mask, centralize, edge_features, localize, node_mean_frames, orientations,
)
from bio_diffusion_torch.ops.message_layer import (
    fused_message_layer, pack_chain_weights, pack_gcp1_weights,
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
    """eps-prediction denoiser: ``(xh [B, N, 3+F], t [B, 1], node_mask [B, N])
    -> [B, N, 3+F]`` (CoM-free velocity | eps_h), float32 out.

    ``compute_dtype`` ("bfloat16" or None) is the network body's dtype.  The
    forward reads a packed, cast copy of the weights made on first use after
    construction, ``to()`` or ``load_state_dict``; weights changed in place
    otherwise are not seen (this module serves, it does not train)."""

    def __init__(self, model_cfg: ModelConfig, module_cfg: ModuleConfig, layer_cfg: LayerConfig,
                 diffusion_cfg: DiffusionConfig, dataloader_cfg: DataloaderConfig,
                 compute_dtype: Optional[str] = None):
        super().__init__()
        if not supports_fast_path(module_cfg, layer_cfg):
            raise NotImplementedError("GCPNet configuration outside the port's packed forward")
        if diffusion_cfg.self_condition or module_cfg.conditioning:
            raise NotImplementedError("self-conditioning and property conditioning are not ported yet")
        self.model_cfg, self.module_cfg, self.layer_cfg = model_cfg, module_cfg, layer_cfg
        self.diffusion_cfg, self.dataloader_cfg = diffusion_cfg, dataloader_cfg
        self.compute_dtype = {None: torch.float32, "bfloat16": torch.bfloat16}[compute_dtype]
        mc = model_cfg
        h_in = compute_num_atom_types(dataloader_cfg) + int(dataloader_cfg.include_charges)
        h_cond = int(diffusion_cfg.condition_on_time)
        node_dims = (mc.h_hidden_dim, mc.chi_hidden_dim)
        edge_dims = (mc.e_hidden_dim, mc.xi_hidden_dim)
        self.gcp_embedding = GCPEmbedding(
            (mc.e_input_dim, mc.xi_input_dim), (h_in + h_cond, mc.chi_input_dim),
            edge_dims, node_dims, module_cfg,
        )
        self.interaction_layers = nn.ModuleList([
            GCPInteractions(node_dims, edge_dims, module_cfg, layer_cfg)
            for _ in range(mc.num_encoder_layers)
        ])
        self.scalar_node_projection_gcp = GCP2(node_dims, (h_in + h_cond, 0), (None, None))
        self._packed: Optional[Dict[str, Any]] = None
        self.register_load_state_dict_post_hook(lambda module, keys: module._drop_packed())

    def _drop_packed(self) -> None:
        self._packed = None

    def _apply(self, fn, *args, **kwargs):
        self._packed = None
        return super()._apply(fn, *args, **kwargs)

    def packed_weights(self) -> Dict[str, Any]:
        """Weights in the compute dtype, message layers packed for the kernel."""
        if self._packed is None:
            cdt, mc = self.compute_dtype, self.model_cfg
            with torch.no_grad():
                layers = []
                for layer in self.interaction_layers:
                    mp = layer.interaction
                    layers.append({
                        "g1": pack_gcp1_weights(mp.message_fusion[0], mc.h_hidden_dim,
                                                mc.chi_hidden_dim, mc.xi_hidden_dim, cdt),
                        "chain": pack_chain_weights(mp.message_fusion[1:],
                                                    mp.scalar_message_attention[0], cdt),
                        "ff": layer.feedforward_network[0].weights(cdt),
                        "pos": layer.node_position_update_gcp.weights(cdt),
                    })
                self._packed = {
                    "edge": self.gcp_embedding.edge_embedding.weights(cdt),
                    "node": self.gcp_embedding.node_embedding.weights(cdt),
                    "layers": layers,
                    "proj": self.scalar_node_projection_gcp.weights(cdt),
                }
        return self._packed

    def forward(self, xh: Tensor, t: Tensor, node_mask: Tensor) -> Tensor:
        mc, dl = self.model_cfg, self.dataloader_cfg
        cdt = self.compute_dtype
        w = self.packed_weights()
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
        if self.diffusion_cfg.condition_on_time:
            h = torch.cat([h, t[:, None, :].expand(b, n, t.shape[-1]).to(h.dtype)], dim=-1)
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
            s_agg, v_agg = fused_message_layer(
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
        if self.diffusion_cfg.condition_on_time:
            h_out = h_out[..., :-1]
        # a non-finite velocity anywhere zeroes the whole batch's velocity
        vel = torch.where(torch.isfinite(vel).all(), vel, torch.zeros_like(vel))
        _, vel = centralize(vel, node_mask)
        return torch.cat([vel, h_out], dim=-1)
