"""Property-classifier training and its checkpoint directory.

Port of ``bio_diffusion_tpu/train/classifier_train.py``.  An
``EGNNClassifier`` learns one property column of a ``DenseDataset``: L1 loss
on the mean/MAD-normalized label, AdamW under a cosine learning-rate decay
over ``epochs * steps_per_epoch`` updates (optax's
``cosine_decay_schedule``: the first update uses ``lr``), the JAX package's
batches for the same seed, and the parameters of the best validation MAE.

The checkpoint directory is the JAX package's layout: ``classifier.npz``
(one array per parameter under the JAX package's key strings,
``"['params']['gcl_0']['edge_mlp_0']['kernel']"``, kernels ``[in, out]``)
and ``classifier.json`` (architecture and the property's normalizer), so a
directory written by either package loads in the other.
"""

from __future__ import annotations

import json
import math
import os
import re
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from bio_diffusion_torch.data.batch import DenseDataset, iterate_dense_batches
from bio_diffusion_torch.models.classifier import EGNNClassifier
from bio_diffusion_torch.models.distributions import compute_mean_mad
from bio_diffusion_torch.train.torch_import import (
    classifier_jax_paths,
    classifier_state_dict_from_jax_params,
    init_random_weights,
)
from bio_diffusion_torch.utils.logging import get_logger

log = get_logger(__name__)


def _keystr(path) -> str:
    return "".join(f"[{k!r}]" for k in path)


def save_jax_classifier(out_dir: str, classifier: EGNNClassifier, norms: Dict[str, float], prop: str,
                        extra: Optional[Dict[str, Any]] = None) -> str:
    """Write ``classifier.npz`` + ``classifier.json`` into ``out_dir``."""
    os.makedirs(out_dir, exist_ok=True)
    arrays = {_keystr(path): arr for path, arr in classifier_jax_paths(classifier.state_dict()).items()}
    np.savez(os.path.join(out_dir, "classifier.npz"), **arrays)
    meta = {
        "in_node_nf": classifier.in_node_nf, "hidden_nf": classifier.hidden_nf, "n_layers": classifier.n_layers,
        "attention": classifier.attention, "node_attr": classifier.node_attr, "property": prop,
        "mean": float(norms["mean"]), "mad": float(norms["mad"]),
    }
    meta.update(extra or {})
    with open(os.path.join(out_dir, "classifier.json"), "w") as f:
        json.dump(meta, f, indent=2)
    return out_dir


def load_jax_classifier(model_dir: str) -> Tuple[EGNNClassifier, Dict[str, Any]]:
    """A directory written by ``save_jax_classifier`` (either package's) ->
    ``(classifier on the CPU, meta)``; meta carries the property name and
    its training-time mean/MAD."""
    with open(os.path.join(model_dir, "classifier.json")) as f:
        meta = json.load(f)
    classifier = EGNNClassifier(in_node_nf=int(meta["in_node_nf"]), hidden_nf=int(meta["hidden_nf"]),
                                n_layers=int(meta["n_layers"]), attention=bool(meta["attention"]),
                                node_attr=int(meta["node_attr"]))
    tree: Dict[str, Any] = {}
    with np.load(os.path.join(model_dir, "classifier.npz")) as arrays:
        for key in arrays.files:
            node = tree
            *parents, leaf = re.findall(r"\['([^']*)'\]", key)
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = arrays[key]
    state_dict = {k: torch.from_numpy(np.array(v)) for k, v in classifier_state_dict_from_jax_params(tree).items()}
    classifier.load_state_dict(state_dict, strict=True)
    return classifier, meta


def is_jax_classifier_dir(model_dir: str) -> bool:
    return os.path.isfile(os.path.join(model_dir, "classifier.json")) and os.path.isfile(
        os.path.join(model_dir, "classifier.npz"))


def cosine_decay(lr: float, decay_steps: int, count: int) -> float:
    """optax ``cosine_decay_schedule(lr, decay_steps)`` at update ``count`` (from 0)."""
    count = min(count, decay_steps)
    return lr * 0.5 * (1.0 + math.cos(math.pi * count / decay_steps))


def property_batches(ds: DenseDataset, prop: str, batch_size: int, pad_to: int, shuffle: bool,
                     rng: Optional[np.random.Generator] = None, drop_last: bool = True):
    """``(numpy DenseMolBatch, raw labels [B] float32)`` in the JAX
    package's order: one ``rng.shuffle`` of the molecule order per pass."""
    order = np.arange(len(ds))
    if shuffle:
        rng.shuffle(order)
    values = ds.property_values(prop)
    for start in range(0, len(ds), batch_size):
        sel = order[start: start + batch_size]
        if len(sel) < batch_size and drop_last:
            break
        sub = DenseDataset({k: np.asarray(v)[sel] for k, v in ds.data.items()}, ds.included_species)
        batch = next(iterate_dense_batches(sub, batch_size, shuffle=False, drop_last=False, pad_to=pad_to))
        yield batch, values[sel].astype(np.float32)


def train_property_classifier(
    datasets: Dict[str, Any],
    prop: str,
    num_atom_types: int,
    hidden_nf: int = 128,
    n_layers: int = 7,
    attention: bool = True,
    epochs: int = 100,
    batch_size: int = 96,
    lr: float = 1e-3,
    weight_decay: float = 1e-16,
    pad_to: Optional[int] = None,
    seed: int = 0,
    log_every: int = 20,
    device="cuda",
    state_dict: Optional[Dict[str, Any]] = None,
) -> Tuple[EGNNClassifier, Dict[str, float], Dict[str, Any]]:
    """Train an ``EGNNClassifier`` on ``datasets["train"]``'s ``prop`` column
    on ``device`` -> ``(classifier holding the best parameters, norms,
    history)``.  Initial weights from ``state_dict`` (reference names) or
    drawn from ``seed``.  Validation MAE is on the data scale,
    ``|mad * pred + mean - label|``; without a valid split the last
    parameters are kept."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device=cuda but no CUDA device is available (there is no CPU fallback)")
    train_ds, valid_ds = datasets["train"], datasets.get("valid")
    norms = compute_mean_mad(train_ds.property_values(prop))
    mean, mad = norms["mean"], norms["mad"]
    if pad_to is None:
        pad_to = int(train_ds.data["positions"].shape[1])

    classifier = EGNNClassifier(in_node_nf=num_atom_types, hidden_nf=hidden_nf, n_layers=n_layers,
                                attention=attention)
    if state_dict is not None:
        classifier.load_state_dict({k: torch.as_tensor(np.array(v)) for k, v in state_dict.items()}, strict=True)
    else:
        init_random_weights(classifier, seed)
    classifier.to(device)
    steps_per_epoch = max(1, len(train_ds) // batch_size)
    decay_steps = max(1, epochs * steps_per_epoch)
    opt = torch.optim.AdamW(classifier.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=weight_decay)

    def on_device(batch):
        b = batch.to(device)
        return b.one_hot, b.x, b.node_mask

    def run_eval(ds) -> float:
        total, count = 0.0, 0
        with torch.no_grad():
            for batch, label in property_batches(ds, prop, batch_size, pad_to, shuffle=False, drop_last=False):
                pred = classifier(*on_device(batch))
                label = torch.from_numpy(label).to(device)
                total += float((mad * pred + mean - label).abs().sum())
                count += len(label)
        return total / max(count, 1)

    rng = np.random.default_rng(seed)
    best_mae, best = float("inf"), None
    history: Dict[str, Any] = {"train_loss": [], "valid_mae": []}
    step = 0
    for epoch in range(epochs):
        classifier.train()
        losses = []
        for batch, label in property_batches(train_ds, prop, batch_size, pad_to, True, rng):
            for group in opt.param_groups:
                group["lr"] = cosine_decay(lr, decay_steps, step)
            target = (torch.from_numpy(label).to(device) - mean) / mad
            loss = (classifier(*on_device(batch)) - target).abs().mean()
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            losses.append(loss.detach())  # read once per epoch, not per step
            if step % log_every == 0:
                log.info("classifier epoch %d step %d: L1=%.4f", epoch, step, float(loss.detach()))
            step += 1
        classifier.eval()
        history["train_loss"].append(float(np.mean([float(v) for v in losses])) if losses else float("nan"))
        if valid_ds is not None:
            mae = run_eval(valid_ds)
            history["valid_mae"].append(mae)
            if mae < best_mae:
                best_mae = mae
                best = {k: v.detach().clone() for k, v in classifier.state_dict().items()}
            log.info("classifier epoch %d: valid MAE=%.4f (best %.4f)", epoch, mae, best_mae)
    if best is not None:
        classifier.load_state_dict(best)
    history["best_valid_mae"] = float(best_mae) if np.isfinite(best_mae) else None
    return classifier.eval(), norms, history
