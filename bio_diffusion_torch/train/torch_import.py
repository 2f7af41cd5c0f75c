"""Carry weights into the port: from a JAX params tree, a reference
checkpoint, or drawn from a seed (:func:`init_random_weights`).

The port's modules carry the reference (PyTorch-Lightning) state_dict names,
so a reference ``.ckpt`` loads by name after dropping its ``ddpm.`` prefix and
its non-parameter entries.  :func:`state_dict_from_jax_params` is the jax-free
counterpart of ``bio_diffusion_tpu/train/torch_import.py::export_state_dict``:
it turns the JAX package's params tree (nested dicts of numpy arrays) into
reference-named arrays; :func:`classifier_state_dict_from_jax_params` does
the same for the property classifier's params.
"""

from __future__ import annotations

import math
import re
from typing import Any, Dict, List

import numpy as np
import torch
from torch import nn

# flax module-list names whose integer suffix is a reference container index
_INDEXED_CONTAINERS = ("interaction_layers", "message_fusion", "feedforward_network",
                       "gcp_norm", "gcp_dropout",
                       # the EGNN denoiser's ModuleList and Sequentials
                       "mpnn_layers", "edge_mlp", "node_mlp", "coors_mlp")
# reference entries that are not parameters of the port's modules: the
# predefined schedule's table (``gamma.gamma``; a learned schedule's
# ``gamma.gamma_0`` / ``gamma.gamma_1`` are parameters), the size
# distribution and the metrics
_SKIP_NAMES = ("gamma.gamma",)
_SKIP_PREFIXES = ("num_nodes_distribution", "molecular_metrics")


def _flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        else:
            out[key] = v
    return out


def state_dict_from_jax_params(params: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """JAX params tree (``{'params': ...}`` or its content) -> reference
    state_dict names (``ddpm.dynamics_network....``) with torch layouts."""
    flat = _flatten(params["params"] if "params" in params else params)
    out = {}
    for key, arr in flat.items():
        parts = key.split("/")
        arr = np.asarray(arr)
        if parts[-1] == "kernel":  # flax Dense [in, out] -> torch Linear [out, in]
            parts = parts[:-1] + ["weight"]
            arr = arr.T
        elif parts[-1] == "weight" and parts[0] == "gamma" and arr.ndim == 2:
            arr = arr.T  # the learned schedule's PositiveLinear keeps [in, out] in JAX
        elif parts[-1] == "scale" and len(parts) >= 2 and parts[-2] == "scalar_norm":
            parts = parts[:-1] + ["weight"]
        names: List[str] = []
        for p in parts:
            m_egnn = re.fullmatch(r"egnn_mpnn_layers_(\d+)", p)
            if m_egnn:  # one flax module for the reference's egnn.mpnn_layers.<i>
                names.extend(["egnn", "mpnn_layers", m_egnn.group(1)])
            elif p == "dynamics":
                names.append("dynamics_network")
            elif p == "scalar_out_head":
                continue
            elif p.startswith("scalar_out_") and p[len("scalar_out_"):].isdigit():
                names.extend(["scalar_out", p.split("_")[-1]])
            elif p == "scalar_message_attention":
                names.extend(["scalar_message_attention", "0"])
            else:
                m = re.fullmatch(r"(" + "|".join(_INDEXED_CONTAINERS) + r")_(\d+)", p)
                names.extend([m.group(1), m.group(2)] if m else [p])
        out["ddpm." + ".".join(names)] = arr
    return out


# the property classifier's nn.Sequential containers: flax names them
# ``edge_mlp_0``, the reference ``edge_mlp.0``
_CLASSIFIER_SEQUENTIALS = ("edge_mlp", "node_mlp", "att_mlp", "node_dec", "graph_dec")


def classifier_state_dict_from_jax_params(params: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """The JAX package's ``EGNNClassifier`` params tree (``{'params': ...}``
    or its content) -> the reference classifier's state_dict names
    (``gcl_0.edge_mlp.0.weight``), flax ``kernel [in, out]`` as torch
    ``weight [out, in]``: the inverse of the JAX package's
    ``models/classifier.py::_map_classifier_key``."""
    flat = _flatten(params["params"] if "params" in params else params)
    out = {}
    for key, arr in flat.items():
        parts = key.split("/")
        arr = np.asarray(arr)
        if parts[-1] == "kernel":
            parts, arr = parts[:-1] + ["weight"], arr.T
        names: List[str] = []
        for p in parts:
            m = re.fullmatch(r"(" + "|".join(_CLASSIFIER_SEQUENTIALS) + r")_(\d+)", p)
            names.extend([m.group(1), m.group(2)] if m else [p])
        out[".".join(names)] = arr
    return out


def classifier_jax_paths(state_dict: Dict[str, Any]) -> Dict[tuple, np.ndarray]:
    """A classifier state_dict -> ``{flax path: array}`` in the JAX
    package's layout (``('params', 'gcl_0', 'edge_mlp_0', 'kernel')``,
    kernels ``[in, out]``): the inverse of
    :func:`classifier_state_dict_from_jax_params`."""
    out = {}
    for name, value in state_dict.items():
        arr = value.detach().cpu().numpy() if torch.is_tensor(value) else np.asarray(value)
        parts = name.split(".")
        path: List[str] = []
        i = 0
        while i < len(parts):
            if parts[i] in _CLASSIFIER_SEQUENTIALS and i + 1 < len(parts) and parts[i + 1].isdigit():
                path.append(f"{parts[i]}_{parts[i + 1]}")
                i += 2
            else:
                path.append(parts[i])
                i += 1
        if path[-1] == "weight" and arr.ndim == 2:
            path[-1], arr = "kernel", arr.T
        out[("params", *path)] = arr
    return out


def load_reference_state_dict(evd: nn.Module, state_dict: Dict[str, Any]) -> None:
    """Load reference-named weights (``ddpm.`` prefix optional) into the
    port's EVD, strictly: every parameter must be present and nothing else."""
    own = {}
    for name, value in state_dict.items():
        name = name[len("ddpm."):] if name.startswith("ddpm.") else name
        if name in _SKIP_NAMES or name.startswith(_SKIP_PREFIXES) or re.match(r"^(train|val|test)_", name):
            continue
        own[name] = value if torch.is_tensor(value) else torch.from_numpy(np.array(value))
    evd.load_state_dict(own, strict=True)


def load_reference_checkpoint(evd: nn.Module, ckpt_path: str) -> None:
    """Load a reference Lightning ``.ckpt`` (its ``state_dict``) into the EVD."""
    payload = torch.load(ckpt_path, map_location="cpu", weights_only=False)
    load_reference_state_dict(evd, payload.get("state_dict", payload))


def init_random_weights(module: nn.Module, seed: int) -> None:
    """Draw every Linear's weight and bias from U(-1/sqrt(fan_in), 1/sqrt(fan_in))
    (PyTorch's default Linear distribution) with a generator seeded by
    ``seed``, the EGNN's MLP layers (``XavierLinear``) from the JAX
    package's xavier-normal (a normal truncated at two deviations, variance
    2/(fan_in + fan_out)) with zero biases, and reset the norms (LayerNorm
    and the EGNN's graph norm: ones and zeros; its ``CoorsNorm.scale``:
    1e-2); then reset a learned noise schedule from the same generator (its
    initialization: the same distribution, weights offset by -2, endpoints
    -5 and 10), so the denoiser's weights do not depend on the schedule."""
    from bio_diffusion_torch.models.diffusion import GammaNetwork
    from bio_diffusion_torch.models.egnn import CoorsNorm, GraphLayerNorm, XavierLinear

    gen = torch.Generator().manual_seed(int(seed))
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, XavierLinear):
                std = math.sqrt(2.0 / (m.in_features + m.out_features)) / 0.87962566103423978
                m.weight.copy_(nn.init.trunc_normal_(torch.empty(m.weight.shape), 0.0, std, -2 * std, 2 * std,
                                                     generator=gen))
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.Linear):
                bound = 1.0 / math.sqrt(m.in_features) if m.in_features > 0 else 0.0
                m.weight.copy_(torch.empty(m.weight.shape).uniform_(-bound, bound, generator=gen))
                if m.bias is not None:
                    m.bias.copy_(torch.empty(m.bias.shape).uniform_(-bound, bound, generator=gen))
            elif isinstance(m, (nn.LayerNorm, GraphLayerNorm)):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, CoorsNorm):
                m.scale.fill_(m.scale_init)
        for m in module.modules():
            if isinstance(m, GammaNetwork):
                m.reset_parameters(gen)
