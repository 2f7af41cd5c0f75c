"""GCP and GCP2: the geometry-complete perceptrons.

Port of ``bio_diffusion_tpu/models/gcp.py`` (``GCP2``, ``GCP``,
``make_gcp``), computing in the coords-major layout of
``models/gcpnet_fast.py::_gcp2_apply_cm``: vectors ``[..., 3, V]`` and frames
``[..., 3, 3]`` (axes on dim -2; callers pass per-node mean frames for node
inputs and per-edge frames for edge inputs).  Every option of the reference
is here: the vector gate, the frame gate, the norm gate, vector residuals,
the three ablations, scalar-only inputs (zero vector outputs) and GCP v1's
frame update after its scalar MLP.  Submodule names are the reference's, so
its state_dict keys load: ``vector_down``, ``vector_down_frames``,
``scalar_out`` (or ``scalar_out.0`` / ``scalar_out.2`` with
``feedforward_out``), ``vector_up``, ``vector_out_scale``,
``vector_out_scale_frames``, ``vector_up_frames``, ``scalar_out_frames``,
``vector_out_scale_sigma_frames``.

A forward casts each weight to its input's dtype (JAX's ``Linear``); the
packed forward hands in weights already cast (``weights=``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from bio_diffusion_torch.models.nn import get_nonlinearity, is_identity
from bio_diffusion_torch.ops.geometry import safe_norm, scalarize, vectorize

Tensor = torch.Tensor
Weights = Dict[str, Tensor]
SV_DIM = 3  # the frame projections' channels (scalarization_vectorization_output_dim)


def _linear(x: Tensor, w: Weights, name: str) -> Tensor:
    bias = w.get(name + ".bias")
    return F.linear(x, w[name + ".weight"].to(x.dtype), None if bias is None else bias.to(x.dtype))


def _scalarize_cm(v_cm: Tensor, frames: Tensor) -> Tensor:
    """``scalarize`` of coords-major ``[..., 3, C]`` vectors -> ``[..., C*3]``."""
    return scalarize(v_cm.transpose(-1, -2), frames.to(v_cm.dtype))


def _vectorize_cm(gate: Tensor, frames: Tensor) -> Tensor:
    """``vectorize`` returning coords-major ``[..., 3, C]``."""
    return vectorize(gate, frames.to(gate.dtype)).transpose(-1, -2)


def _scalar_head(merged: int, s_out: int, feedforward_out: bool) -> nn.Module:
    """``scalar_out``: one Linear, or Linear-SiLU-Linear with ``feedforward_out``."""
    if feedforward_out:
        return nn.Sequential(nn.Linear(merged, s_out), nn.SiLU(), nn.Linear(s_out, s_out))
    return nn.Linear(merged, s_out)


class _GCPBase(nn.Module):
    def __init__(self, input_dims, output_dims, nonlinearities=("silu", "silu"), feedforward_out=False,
                 bottleneck=1, vector_gate=True, frame_gate=False, sigma_frame_gate=False, vector_residual=False,
                 vector_frame_residual=False, ablate_frame_updates=False, ablate_scalars=False,
                 ablate_vectors=False):
        super().__init__()
        self.input_dims, self.output_dims = tuple(input_dims), tuple(output_dims)
        self.nonlinearities = tuple(nonlinearities)
        self.feedforward_out, self.vector_gate, self.frame_gate = feedforward_out, vector_gate, frame_gate
        self.sigma_frame_gate, self.vector_residual = sigma_frame_gate, vector_residual
        self.vector_frame_residual = vector_frame_residual
        self.ablate_frame_updates, self.ablate_scalars = ablate_frame_updates, ablate_scalars
        self.ablate_vectors = ablate_vectors
        v_in, v_out = self.input_dims[1], self.output_dims[1]
        if vector_residual and v_in and v_out and v_in != v_out:
            # JAX fails at the same add (a shape error when the model is built)
            raise ValueError(f"vector_residual adds the {v_in} input vector channels to the {v_out} outputs")
        self.hidden_dim = v_in // bottleneck if bottleneck > 1 else max(v_in, v_out)
        self.vector_gated = not is_identity(self.nonlinearities[1])
        self._acts()  # an unknown nonlinearity raises here

    def _acts(self):
        # leakyrelu at get_nonlinearity's slope: JAX's make_gcp passes no
        # layer_cfg.nonlinearity_slope either
        return get_nonlinearity(self.nonlinearities[0]), get_nonlinearity(self.nonlinearities[1])

    def _weights(self, weights: Optional[Weights]) -> Weights:
        return weights if weights is not None else dict(self.named_parameters())

    def _scalar_out(self, merged: Tensor, w: Weights) -> Tensor:
        if self.feedforward_out:
            return _linear(F.silu(_linear(merged, w, "scalar_out.0")), w, "scalar_out.2")
        return _linear(merged, w, "scalar_out")

    def _ablated_inputs(self, s: Tensor, v_cm: Optional[Tensor]):
        if self.ablate_scalars:
            s = torch.zeros_like(s)
        if self.ablate_vectors and v_cm is not None:
            v_cm = torch.zeros_like(v_cm)
        return s, v_cm

    def _norm_gate(self, v: Tensor, vector_act) -> Tensor:
        return v * vector_act(safe_norm(v, dim=-2, keepdim=True))

    def _frame_gate(self, s_pre: Tensor, frames: Tensor, vector_act, w: Weights) -> Tensor:
        """``vector_act(|vector_up_frames(vectorize(gate, frames))|)`` ``[..., 1, V_out]``."""
        gate = _linear(vector_act(s_pre), w, "vector_out_scale_frames")
        gv = _linear(_vectorize_cm(gate, frames), w, "vector_up_frames")
        return vector_act(safe_norm(gv, dim=-2, keepdim=True))

    def _scalar_only(self, s_pre: Tensor, scalar_act) -> Tuple[Tensor, None]:
        """A module without vector outputs: the ablation zeroes its scalars before the activation."""
        return scalar_act(torch.zeros_like(s_pre) if self.ablate_scalars else s_pre), None

    def _ablated_outputs(self, s: Tensor, v: Optional[Tensor]):
        if self.ablate_scalars:
            s = torch.zeros_like(s)
        if self.ablate_vectors and v is not None:
            v = torch.zeros_like(v)
        return s, v


class GCP2(_GCPBase):
    """Geometry-complete perceptron v2: frame scalarization before the scalar
    MLP (reference gcpnet.py:265-491).  The trained configuration is
    ``vector_gate=True, frame_gate=False`` (sigmoid vector gates)."""

    def __init__(self, input_dims, output_dims, nonlinearities=("silu", "silu"), feedforward_out=False,
                 bottleneck=1, **options):
        super().__init__(input_dims, output_dims, nonlinearities, feedforward_out, bottleneck, **options)
        s_in, v_in = self.input_dims
        s_out, v_out = self.output_dims
        merged = s_in
        if v_in:
            self.vector_down = nn.Linear(v_in, self.hidden_dim, bias=False)
            merged += self.hidden_dim
            if not self.ablate_frame_updates:
                self.vector_down_frames = nn.Linear(v_in, SV_DIM, bias=False)
                merged += 3 * SV_DIM
        self.scalar_out = _scalar_head(merged, s_out, feedforward_out)
        if v_in and v_out:
            self.vector_up = nn.Linear(self.hidden_dim, v_out, bias=False)
            if self.frame_gate and not self.ablate_frame_updates:
                self.vector_out_scale_frames = nn.Linear(s_out, 3 * SV_DIM)
                self.vector_up_frames = nn.Linear(SV_DIM, v_out, bias=False)
            elif self.vector_gate:
                self.vector_out_scale = nn.Linear(s_out, v_out)

    def forward(self, s: Tensor, v_cm: Optional[Tensor], frames: Tensor,
                weights: Optional[Weights] = None) -> Tuple[Tensor, Optional[Tensor]]:
        """``(s [..., S_in], v_cm [..., 3, V_in] or None, frames [..., 3, 3])``
        -> ``(s_out, v_out [..., 3, V_out] or None)``; ``weights`` (state_dict
        name -> tensor) overrides the parameters, e.g. with cast copies."""
        w = self._weights(weights)
        scalar_act, vector_act = self._acts()
        v_in, v_out = self.input_dims[1], self.output_dims[1]
        s, v_cm = self._ablated_inputs(s, v_cm if v_in else None)
        vh = None
        if v_in:
            vh = _linear(v_cm, w, "vector_down")  # [..., 3, H]
            parts = [s, safe_norm(vh, dim=-2)]
            if not self.ablate_frame_updates:
                parts.append(_scalarize_cm(_linear(v_cm, w, "vector_down_frames"), frames))
            merged = torch.cat(parts, dim=-1)
        else:
            merged = s
        s_pre = self._scalar_out(merged, w)
        if not v_out:
            return self._scalar_only(s_pre, scalar_act)
        if not v_in:
            v = s_pre.new_zeros(s_pre.shape[:-1] + (3, v_out))
        else:
            v = _linear(vh, w, "vector_up")  # [..., 3, V_out]
            if self.vector_residual:
                v = v + v_cm
            if self.frame_gate and not self.ablate_frame_updates:
                v = v * self._frame_gate(s_pre, frames, vector_act, w)
            elif self.vector_gate:
                v = v * torch.sigmoid(_linear(vector_act(s_pre), w, "vector_out_scale"))[..., None, :]
            elif self.vector_gated:
                v = self._norm_gate(v, vector_act)
        return self._ablated_outputs(scalar_act(s_pre), v)


class GCP(_GCPBase):
    """Geometry-complete perceptron v1: the frame update after the scalar MLP
    (reference gcpnet.py:35-262; ``module_cfg.selected_gcp=gcp``)."""

    def __init__(self, input_dims, output_dims, nonlinearities=("silu", "silu"), feedforward_out=False,
                 bottleneck=1, **options):
        super().__init__(input_dims, output_dims, nonlinearities, feedforward_out, bottleneck, **options)
        s_in, v_in = self.input_dims
        s_out, v_out = self.output_dims
        if v_in:
            self.vector_down = nn.Linear(v_in, self.hidden_dim, bias=False)
        self.scalar_out = _scalar_head(s_in + (self.hidden_dim if v_in else 0), s_out, feedforward_out)
        if v_in and v_out:
            self.vector_up = nn.Linear(self.hidden_dim, v_out, bias=False)
            if self.vector_gate:
                self.vector_out_scale = nn.Linear(s_out, v_out)
        if not self.ablate_frame_updates and (v_in or v_out):
            # the frame update reads the vector output (zeros where there is none)
            self.vector_down_frames = nn.Linear(v_out if v_out else self.hidden_dim, SV_DIM, bias=False)
            self.scalar_out_frames = nn.Linear(s_out + 3 * SV_DIM, s_out)
            if v_in and v_out:
                if self.sigma_frame_gate:
                    self.vector_out_scale_sigma_frames = nn.Linear(s_out, v_out)
                elif self.frame_gate:
                    self.vector_out_scale_frames = nn.Linear(s_out, 3 * SV_DIM)
                    self.vector_up_frames = nn.Linear(SV_DIM, v_out, bias=False)

    def forward(self, s: Tensor, v_cm: Optional[Tensor], frames: Tensor,
                weights: Optional[Weights] = None) -> Tuple[Tensor, Optional[Tensor]]:
        """As :meth:`GCP2.forward`."""
        w = self._weights(weights)
        scalar_act, vector_act = self._acts()
        v_in, v_out = self.input_dims[1], self.output_dims[1]
        s, v_cm = self._ablated_inputs(s, v_cm if v_in else None)
        if v_in:
            vh = _linear(v_cm, w, "vector_down")
            merged = torch.cat([s, safe_norm(vh, dim=-2)], dim=-1)
        else:
            merged = s
        s_pre = self._scalar_out(merged, w)
        v = None
        if v_in and v_out:
            v = _linear(vh, w, "vector_up")
            if self.vector_residual:
                v = v + v_cm
            if self.vector_gate:
                v = v * torch.sigmoid(_linear(vector_act(s_pre), w, "vector_out_scale"))[..., None, :]
            elif self.vector_gated:
                v = self._norm_gate(v, vector_act)
        s_act = scalar_act(s_pre)
        if v_out and not v_in:
            v = s_act.new_zeros(s_act.shape[:-1] + (3, v_out))
        if not (v_in or v_out):
            return s_act, None  # a scalar module has no frame update (nor output ablation)
        if self.ablate_frame_updates:
            return self._ablated_outputs(s_act, v)

        # the frame update: scalarize the vector output (zeros without one)
        v_pre2 = v if v_out else s_act.new_zeros(s_act.shape[:-1] + (3, self.hidden_dim))
        scalar_hidden = _scalarize_cm(_linear(v_pre2, w, "vector_down_frames"), frames)
        s_pre2 = _linear(torch.cat([s_act, scalar_hidden], dim=-1), w, "scalar_out_frames")
        if not v_out:
            return self._scalar_only(s_pre2, scalar_act)
        if v_in:
            if self.sigma_frame_gate:
                v = v * torch.sigmoid(_linear(vector_act(s_pre2), w, "vector_out_scale_sigma_frames"))[..., None, :]
            elif self.frame_gate:
                v = v * self._frame_gate(s_pre2, frames, vector_act, w)
                if self.vector_frame_residual:
                    v = v + v_pre2
            elif self.vector_gated:
                v = self._norm_gate(v, vector_act)
        return self._ablated_outputs(scalar_act(s_pre2), v)


GCP_CLASSES = {"gcp": GCP, "gcp2": GCP2}


def make_gcp(selected_gcp: str, input_dims: Tuple[int, int], output_dims: Tuple[int, int], module_cfg, *,
             nonlinearities: Optional[Tuple[Optional[str], Optional[str]]] = None,
             bottleneck: Optional[int] = None, vector_residual: Optional[bool] = None,
             feedforward_out: bool = False) -> _GCPBase:
    """A GCP variant from a ``ModuleConfig`` with the reference's per-site
    overrides (``models/gcp.py::make_gcp``)."""
    cls = GCP_CLASSES[selected_gcp.lower()]
    return cls(
        input_dims, output_dims,
        nonlinearities=tuple(nonlinearities) if nonlinearities is not None else module_cfg.nonlinearities,
        feedforward_out=feedforward_out,
        bottleneck=bottleneck if bottleneck is not None else 1,
        vector_gate=module_cfg.vector_gate,
        frame_gate=module_cfg.frame_gate,
        sigma_frame_gate=module_cfg.sigma_frame_gate,
        vector_residual=vector_residual if vector_residual is not None else module_cfg.vector_residual,
        vector_frame_residual=module_cfg.vector_frame_residual,
        ablate_frame_updates=module_cfg.ablate_frame_updates,
        ablate_scalars=module_cfg.ablate_scalars,
        ablate_vectors=module_cfg.ablate_vectors,
    )
