"""Carry weights into the port: from a JAX params tree or a reference checkpoint.

The port's modules carry the reference (PyTorch-Lightning) state_dict names,
so a reference ``.ckpt`` loads by name after dropping its ``ddpm.`` prefix and
its non-parameter entries.  :func:`state_dict_from_jax_params` is the jax-free
counterpart of ``bio_diffusion_tpu/train/torch_import.py::export_state_dict``:
it turns the JAX package's params tree (nested dicts of numpy arrays) into
reference-named arrays.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List

import numpy as np
import torch
from torch import nn

# flax module-list names whose integer suffix is a reference container index
_INDEXED_CONTAINERS = ("interaction_layers", "message_fusion", "feedforward_network",
                       "gcp_norm", "gcp_dropout")
# reference entries that are not parameters of the port's modules
_SKIP_PREFIXES = ("gamma.gamma", "num_nodes_distribution", "molecular_metrics")


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
        elif parts[-1] == "scale" and len(parts) >= 2 and parts[-2] == "scalar_norm":
            parts = parts[:-1] + ["weight"]
        names: List[str] = []
        for p in parts:
            if p == "dynamics":
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


def load_reference_state_dict(evd: nn.Module, state_dict: Dict[str, Any]) -> None:
    """Load reference-named weights (``ddpm.`` prefix optional) into the
    port's EVD, strictly: every parameter must be present and nothing else."""
    own = {}
    for name, value in state_dict.items():
        name = name[len("ddpm."):] if name.startswith("ddpm.") else name
        if name.startswith(_SKIP_PREFIXES) or re.match(r"^(train|val|test)_", name):
            continue
        own[name] = value if torch.is_tensor(value) else torch.from_numpy(np.array(value))
    evd.load_state_dict(own, strict=True)


def load_reference_checkpoint(evd: nn.Module, ckpt_path: str) -> None:
    """Load a reference Lightning ``.ckpt`` (its ``state_dict``) into the EVD."""
    payload = torch.load(ckpt_path, map_location="cpu", weights_only=False)
    load_reference_state_dict(evd, payload.get("state_dict", payload))
