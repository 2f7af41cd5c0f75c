"""Train-state checkpoints of the port: save, exact resume, warm start.

Counterpart of ``bio_diffusion_tpu/train/checkpoints.py``.  The JAX package
writes orbax directories, which cannot be read without JAX; the port writes
its own files, ``<ckpt_dir>/step_<n>.pt`` (``torch.save``, written under a
temporary name and moved into place with ``os.replace``; the newest
``max_to_keep`` are kept, as orbax's ``max_to_keep=3``).  Each holds

* ``state_dict``: the model under the reference's names (``ddpm.<...>``), the
  layout ``train.torch_import.load_reference_checkpoint`` reads, so a port
  checkpoint is also a reference-style ``.ckpt``;
* ``ema_state_dict``: the EMA weights under the same names;
* ``optimizer``: the AMSGrad moments ``mu``, ``nu``, ``nu_max`` by parameter
  name and the optimizer step ``count``;
* ``gradnorm``: the adaptive clipping's grad-norm queue and its position;
* ``step``: the optimizer step the checkpoint was taken at.

The tensors are whole whatever the run's ``trainer.num_model_shards``: a
sharded run gathers its state for the save, and a restore loads the whole
state, which the Trainer then shards, so a file resumes at any shard count.

An orbax directory of the JAX package crosses over only as a reference
``.ckpt`` (``bio_diffusion_tpu/train/torch_import.py::export_state_dict``).
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn

from bio_diffusion_torch.train.state import MOMENTS, TrainState
from bio_diffusion_torch.train.torch_import import load_reference_checkpoint, load_reference_state_dict

PREFIX = "ddpm."
_STEP_FILE = re.compile(r"^step_(\d+)\.pt$")
_SOURCES = {"params": "state_dict", "ema_params": "ema_state_dict"}


def checkpoint_path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{int(step)}.pt")


def _steps(ckpt_dir: str) -> List[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(m.group(1)) for m in map(_STEP_FILE.match, os.listdir(ckpt_dir)) if m)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = _steps(ckpt_dir)
    return steps[-1] if steps else None


def reference_state_dict(module: nn.Module) -> Dict[str, torch.Tensor]:
    """The module's state under the reference's names, on the CPU."""
    return {PREFIX + k: v.detach().cpu() for k, v in module.state_dict().items()}


def _atomic_save(payload: Dict[str, Any], path: str) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def save_checkpoint(ckpt_dir: str, evd: nn.Module, evd_ema: nn.Module, state: TrainState,
                    moments: Dict[str, List[torch.Tensor]], step: Optional[int] = None,
                    max_to_keep: int = 3) -> str:
    """Write ``step_<n>.pt`` (``n`` the optimizer step unless given) and drop
    all but the newest ``max_to_keep``; returns the file's path.  ``evd``
    and ``evd_ema`` hold full weights, ``moments`` the AMSGrad moments at
    full shapes (``TrainState.full_moments``)."""
    step = state.count if step is None else int(step)
    names = [PREFIX + n for n, _ in evd.named_parameters()]
    moments = {key: {n: t.detach().cpu() for n, t in zip(names, moments[key])} for key in MOMENTS}
    os.makedirs(ckpt_dir, exist_ok=True)
    path = checkpoint_path(ckpt_dir, step)
    _atomic_save({
        "state_dict": reference_state_dict(evd),
        "ema_state_dict": reference_state_dict(evd_ema),
        "optimizer": {**moments, "count": state.count},
        "gradnorm": {"buffer": state.gradnorm_buffer.detach().cpu(), "count": state.gradnorm_count},
        "step": step,
    }, path)
    for old in _steps(ckpt_dir)[:-max_to_keep]:
        os.remove(checkpoint_path(ckpt_dir, old))
    return path


def load_checkpoint(ckpt_dir: str, step: Optional[int] = None) -> Dict[str, Any]:
    """The payload of ``step_<step>.pt`` (the newest when ``step`` is None)."""
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"No checkpoint found under {ckpt_dir}")
    return torch.load(checkpoint_path(ckpt_dir, step), map_location="cpu", weights_only=True)


@torch.no_grad()
def restore_checkpoint(ckpt_dir: str, evd: nn.Module, evd_ema: nn.Module, state: TrainState,
                       step: Optional[int] = None) -> int:
    """Restore the weights, EMA weights, optimizer and clipping state in
    place, exactly, into an unsharded state (the Trainer puts it on a model
    axis after); returns the checkpoint's step."""
    payload = load_checkpoint(ckpt_dir, step)
    load_reference_state_dict(evd, payload["state_dict"])
    load_reference_state_dict(evd_ema, payload["ema_state_dict"])
    names = [PREFIX + n for n, _ in evd.named_parameters()]
    opt = payload["optimizer"]
    for key in MOMENTS:
        if set(opt[key]) != set(names):
            raise KeyError(f"checkpoint optimizer state {key!r} does not match the model's parameters")
        for name, t in zip(names, getattr(state, key)):
            t.copy_(opt[key][name])
    state.count = int(opt["count"])
    state.gradnorm_buffer.copy_(payload["gradnorm"]["buffer"])
    state.gradnorm_count = int(payload["gradnorm"]["count"])
    return int(payload["step"])


def merge_partial(template: Dict[str, torch.Tensor], loaded: Dict[str, Any]
                  ) -> Tuple[Dict[str, torch.Tensor], List[str], List[str]]:
    """Name-and-shape intersection: every name of ``template`` that
    ``loaded`` has with the same shape takes the loaded value (in the
    template's dtype); the rest keep the template's.  The counterpart of the
    reference's ``strict=False`` warm start.  Returns ``(merged,
    loaded_names, skipped_names)`` in the template's order."""
    merged, loaded_names, skipped = {}, [], []
    for name, tmpl in template.items():
        value = loaded.get(name)
        if value is not None and tuple(value.shape) == tuple(tmpl.shape):
            merged[name] = torch.as_tensor(value).to(tmpl.dtype)
            loaded_names.append(name)
        else:
            merged[name] = tmpl
            skipped.append(name)
    return merged, loaded_names, skipped


def _with_prefix(state_dict: Dict[str, Any]) -> Dict[str, Any]:
    return {(k if k.startswith(PREFIX) else PREFIX + k): v for k, v in state_dict.items()}


def warm_start_params(ckpt_path: str, template: Dict[str, torch.Tensor], step: Optional[int] = None,
                      source: str = "params") -> Tuple[Dict[str, torch.Tensor], int, List[str]]:
    """Partial weights from a port checkpoint directory (``source`` picks the
    weights, "params", or the EMA weights, "ema_params"), a reference
    ``.ckpt``/``.pt``/``.pth`` or a params file, merged into ``template`` (a
    ``reference_state_dict``).  Returns ``(merged, n_loaded, skipped)``."""
    if source not in _SOURCES:
        raise ValueError(f"warm_start_source must be one of {sorted(_SOURCES)}, not {source!r}")
    if os.path.isdir(ckpt_path):
        loaded = load_checkpoint(ckpt_path, step)[_SOURCES[source]]
    else:
        # a reference Lightning checkpoint holds more than tensors
        payload = torch.load(ckpt_path, map_location="cpu", weights_only=False)
        loaded = payload.get(_SOURCES[source]) or payload.get("state_dict", payload)
    merged, loaded_names, skipped = merge_partial(template, _with_prefix(loaded))
    return merged, len(loaded_names), skipped


def save_params(path: str, module: nn.Module) -> None:
    """A weights-only file (e.g. exported EMA weights), reference layout."""
    _atomic_save({"state_dict": reference_state_dict(module)}, path)


def restore_params(path: str, module: nn.Module) -> None:
    """Load a ``save_params`` file: it is a reference ``.ckpt`` in all but name."""
    load_reference_checkpoint(module, path)
