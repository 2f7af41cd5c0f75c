"""GCP2: the geometry-complete perceptron (vector-gate configuration).

Port of ``bio_diffusion_tpu/models/gcp.py::GCP2`` with the forward of
``models/gcpnet_fast.py::_gcp2_apply_cm``: vectors are coords-major
``[..., 3, V]`` and frames ``[..., 3, 3]`` (axes on dim -2; callers pass
per-node mean frames for node inputs and per-edge frames for edge inputs).
Submodule names are the reference's, so its state_dict keys load:
``vector_down``, ``vector_down_frames``, ``scalar_out`` (or ``scalar_out.0`` /
``scalar_out.2`` with ``feedforward_out``), ``vector_up``, ``vector_out_scale``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from bio_diffusion_torch.ops.geometry import safe_norm

Tensor = torch.Tensor


def _is_identity(name: Optional[str]) -> bool:
    return name is None or name.lower().strip() in ("identity", "none")


def _check_nonlinearity(name: Optional[str]) -> None:
    if not _is_identity(name) and name.lower().strip() != "silu":
        raise NotImplementedError(f"nonlinearity {name!r}: the port implements silu and identity")


class GCP2(nn.Module):
    """Scalar/vector perceptron with frame scalarization and sigmoid vector gates."""

    def __init__(
        self,
        input_dims: Tuple[int, int],
        output_dims: Tuple[int, int],
        nonlinearities: Tuple[Optional[str], Optional[str]] = ("silu", "silu"),
        feedforward_out: bool = False,
        bottleneck: int = 1,
    ):
        super().__init__()
        for name in nonlinearities:
            _check_nonlinearity(name)
        s_in, v_in = input_dims
        s_out, v_out = output_dims
        if v_out and not v_in:
            raise NotImplementedError("GCP2 with vector outputs needs vector inputs in the port")
        self.scalar_act = not _is_identity(nonlinearities[0])
        self.gate_act = not _is_identity(nonlinearities[1])
        self.hidden_dim = v_in // bottleneck if bottleneck > 1 else max(v_in, v_out)
        merged = s_in
        if v_in:
            self.vector_down = nn.Linear(v_in, self.hidden_dim, bias=False)
            self.vector_down_frames = nn.Linear(v_in, 3, bias=False)
            merged += self.hidden_dim + 9
        if feedforward_out:
            self.scalar_out = nn.Sequential(
                nn.Linear(merged, s_out), nn.SiLU(), nn.Linear(s_out, s_out)
            )
        else:
            self.scalar_out = nn.Linear(merged, s_out)
        if v_out:
            self.vector_up = nn.Linear(self.hidden_dim, v_out, bias=False)
            self.vector_out_scale = nn.Linear(s_out, v_out)

    def weights(self, dtype=None) -> Dict[str, Tensor]:
        """Detached parameters keyed by state_dict name, cast to ``dtype``."""
        return {k: p.detach().to(dtype) for k, p in self.named_parameters()}

    def forward(self, s: Tensor, v_cm: Optional[Tensor], frames: Tensor,
                weights: Optional[Dict[str, Tensor]] = None) -> Tuple[Tensor, Optional[Tensor]]:
        """``(s [..., S_in], v_cm [..., 3, V_in], frames [..., 3, 3])`` ->
        ``(s_out, v_out [..., 3, V_out] or None)``; ``weights`` (from
        :meth:`weights`) overrides the parameters, e.g. with cast copies."""
        w = weights if weights is not None else dict(self.named_parameters())
        dt = s.dtype
        parts = [s]
        vh = None
        if "vector_down.weight" in w:
            vh = F.linear(v_cm, w["vector_down.weight"])  # [..., 3, H]
            vnorm = safe_norm(vh, dim=-2)
            parts.append(vnorm.to(dt))
            vdf = F.linear(v_cm, w["vector_down_frames.weight"])  # [..., 3 (k), 3 (c)]
            # out[..., c*3+a] = sum_k frames[a, k] vdf[k, c]
            sc = torch.einsum("...ak,...kc->...ca", frames.to(dt), vdf)
            parts.append(sc.reshape(sc.shape[:-2] + (9,)))
        merged = torch.cat(parts, dim=-1)
        if "scalar_out.0.weight" in w:
            h0 = F.linear(merged, w["scalar_out.0.weight"], w["scalar_out.0.bias"])
            s2 = F.linear(F.silu(h0), w["scalar_out.2.weight"], w["scalar_out.2.bias"])
        else:
            s2 = F.linear(merged, w["scalar_out.weight"], w["scalar_out.bias"])
        v_out = None
        if "vector_up.weight" in w:
            vu = F.linear(vh, w["vector_up.weight"])  # [..., 3, V_out]
            gate_in = F.silu(s2) if self.gate_act else s2
            gate = torch.sigmoid(
                F.linear(gate_in, w["vector_out_scale.weight"], w["vector_out_scale.bias"])
            )
            v_out = vu * gate[..., None, :]
        return (F.silu(s2) if self.scalar_act else s2), v_out
