"""The first message GCP2 evaluated per part, without its per-edge concat.

Port of ``bio_diffusion_tpu/models/gcp_fused.py``: the first message GCP2
reads ``[s_i | e_ij | s_j]`` and ``[v_i | xi_ij | v_j]`` on every edge, but
a Linear over that concat splits into per-node products (computed once a
node, broadcast over the edges) plus a per-edge one, so the ``[B, N, N, 2S
+ Se]`` tensor is never built.  Parameter names and shapes are a plain
GCP2's (``vector_down``, ``vector_down_frames``, ``scalar_out``,
``vector_up``, ``vector_out_scale``), so weights are interchangeable.  Used
where the reference's ``use_fused`` holds (GCP2, frame updates, no frame
gate, no ablation, no ``default_vector_residual``); vectors coords-major.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from bio_diffusion_torch.models.gcp import SV_DIM, _scalarize_cm
from bio_diffusion_torch.models.nn import get_nonlinearity
from bio_diffusion_torch.ops.geometry import safe_norm

Tensor = torch.Tensor


class SplitLinear(nn.Linear):
    """A Linear over a concat of parts it never builds: each part's product
    with its slice of the weight's input columns, broadcast-added (parts may
    differ in leading rank).  Its parameters are the plain Linear's."""

    def __init__(self, split_dims: Sequence[int], out_features: int, bias: bool = True):
        super().__init__(sum(split_dims), out_features, bias=bias)
        self.split_dims = tuple(split_dims)

    def forward(self, parts: Sequence[Tensor]) -> Tensor:  # type: ignore[override]
        out, off = None, 0
        for p, d in zip(parts, self.split_dims):
            y = F.linear(p, self.weight[:, off:off + d].to(p.dtype))
            out = y if out is None else out + y
            off += d
        return out if self.bias is None else out + self.bias.to(out.dtype)


class GCP2FusedEdgeMessage(nn.Module):
    """GCP2 over the per-edge ``(node_i, edge_ij, node_j)`` concat, evaluated
    per part (reference ``GCPMessagePassing.message``, gcpnet.py:676-713)."""

    def __init__(self, node_dims: Tuple[int, int], edge_dims: Tuple[int, int], output_dims: Tuple[int, int],
                 nonlinearities=("silu", "silu"), vector_gate: bool = True, bottleneck: int = 1):
        super().__init__()
        (s_dim, v_dim), (se_dim, ve_dim), (s_out, v_out) = node_dims, edge_dims, output_dims
        self.nonlinearities, self.vector_gate = tuple(nonlinearities), vector_gate
        v_in = 2 * v_dim + ve_dim
        self.hidden_dim = v_in // bottleneck if bottleneck > 1 else max(v_in, v_out)
        self.vector_down = SplitLinear((v_dim, ve_dim, v_dim), self.hidden_dim, bias=False)
        self.vector_down_frames = SplitLinear((v_dim, ve_dim, v_dim), SV_DIM, bias=False)
        self.scalar_out = SplitLinear((s_dim, se_dim, s_dim, self.hidden_dim, 3 * SV_DIM), s_out)
        self.vector_up = nn.Linear(self.hidden_dim, v_out, bias=False)
        if vector_gate:
            self.vector_out_scale = nn.Linear(s_out, v_out)

    def forward(self, s: Tensor, v_cm: Tensor, e: Tensor, xi_cm: Tensor,
                frames: Tensor) -> Tuple[Tensor, Tensor]:
        """``s [B, N, S]``, ``v_cm [B, N, 3, V]``, ``e [B, N, N, Se]``, ``xi_cm
        [B, N, N, 3, Ve]``, ``frames [B, N, N, 3, 3]`` -> ``(s [B, N, N, S_out],
        v_cm [B, N, N, 3, V_out])``."""
        scalar_act, vector_act = (get_nonlinearity(name) for name in self.nonlinearities)
        v_parts = [v_cm[:, :, None], xi_cm, v_cm[:, None]]
        vh = self.vector_down(v_parts)  # [B, N, N, 3, H]
        scalar_hidden = _scalarize_cm(self.vector_down_frames(v_parts), frames)  # [B, N, N, 9]
        s_pre = self.scalar_out([s[:, :, None], e, s[:, None], safe_norm(vh, dim=-2), scalar_hidden])
        v = F.linear(vh, self.vector_up.weight.to(vh.dtype))
        if self.vector_gate:
            lin = self.vector_out_scale
            v = v * torch.sigmoid(F.linear(vector_act(s_pre), lin.weight.to(s_pre.dtype),
                                           lin.bias.to(s_pre.dtype)))[..., None, :]
        else:
            v = v * vector_act(safe_norm(v, dim=-2, keepdim=True))
        return scalar_act(s_pre), v
