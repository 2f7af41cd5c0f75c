"""Property-conditional generation evaluation (PyTorch).

Port of ``bio_diffusion_tpu/cli/mol_gen_eval_conditional_qm9.py``.  Loads a
property-conditioned generator, samples molecules with contexts drawn from
the per-size property histograms, scores them with the EGNN property
classifier and reports the MAE between its prediction and the conditioning
value; writes ``<output_dir>/conditional_eval_<property>.json``.

The config is edited at run time as the reference does: ``conditioning:
[property]``, ``norm_values: [1, 8, 1]``, ``include_charges: false`` and
``dataset: QM9_second_half`` (unless ``synthetic``).

Usage:
  python -m bio_diffusion_torch.cli.mol_gen_eval_conditional_qm9 \\
      generator_model_filepath=<ckpt> classifier_model_dir=<dir> property=alpha \\
      [iterations=100] [batch_size=100] [num_timesteps=T] [single_bucket=false] \\
      [save_molecules=false] [device=cuda|cpu] [precision=fp32|bf16] \\
      [task=edm|qualitative] [num_sweeps=10] [sweep_n_frames=100] \\
      [output_dir=DIR] [k=v ...]

``generator_model_filepath`` (or ``ckpt_path``) takes what
``mol_gen_sample``'s ``ckpt_path`` takes.  ``classifier_model_dir`` is a
``classifier.npz``/``classifier.json`` directory (``cli.train_classifier``
of either package) or the reference layout (``args.pickle`` +
``best_checkpoint.npy``); a path that is not a directory raises, and
without the key a classifier drawn from seed 0 scores the molecules, for
smoke runs only.  Sizes for all iterations are drawn up
front and sorted, and each batch pads to its own multiple of 2
(``single_bucket=true``: every batch to the dataset's largest molecule).
``task=qualitative`` (or ``sweep_property_values=true``) runs the
fixed-noise property sweep instead: ``num_sweeps`` (default 10) batches of
``sweep_n_frames`` (default 100) molecules of 19 atoms that share one noise
draw, conditioned on a ``linspace`` over the property's range at 19 atoms;
each sweep's molecules go to ``<output_dir>/<property>/sweep_<i>`` as
``conditional_*.xyz`` files, rendered to ``output.gif`` where matplotlib
and imageio are installed.  ``device`` defaults to ``cuda``; there is no
fallback to the CPU.
"""

from __future__ import annotations

import json
import os
import sys
from typing import Any, Dict, Tuple

import numpy as np
import torch

from bio_diffusion_torch.cli.common import (
    device_of,
    load_model,
    nodes_distribution_for,
    parse_cli,
    precision_of,
    with_precision,
)
from bio_diffusion_torch.config.build import build_datasets, build_experiment, get_dataset_info_for
from bio_diffusion_torch.data.batch import broadcast_context, select_bucket
from bio_diffusion_torch.models.classifier import EGNNClassifier, load_reference_classifier
from bio_diffusion_torch.models.distributions import property_normalizers
from bio_diffusion_torch.train.classifier_train import is_jax_classifier_dir, load_jax_classifier
from bio_diffusion_torch.train.sampling import SegmentedSampler, make_node_mask
from bio_diffusion_torch.train.torch_import import init_random_weights
from bio_diffusion_torch.utils.logging import get_logger

log = get_logger(__name__)


def apply_conditional_surgery(cfg: Dict[str, Any], prop: str) -> Dict[str, Any]:
    """The reference's run-time config edits for a conditional QM9 model."""
    model = cfg.setdefault("model", {})
    model.setdefault("module_cfg", {})["conditioning"] = [prop]
    model.setdefault("diffusion_cfg", {})["norm_values"] = [1.0, 8.0, 1.0]
    dm = cfg.setdefault("datamodule", {}).setdefault("dataloader_cfg", {})
    if dm.get("dataset") != "synthetic":
        dm["dataset"] = "QM9_second_half"
    dm["include_charges"] = False
    return cfg


def load_classifier(classifier_dir, prop: str, device) -> Tuple[EGNNClassifier, Dict[str, Any]]:
    """The classifier of ``classifier_dir`` (either layout) or, when no
    directory is given, one drawn from seed 0 (with a warning) ->
    ``(classifier on device in eval mode, meta)``; meta holds the
    training-time normalizer of a ``classifier.json`` directory, else
    nothing.  A given path that is not a directory raises."""
    meta: Dict[str, Any] = {}
    if classifier_dir:
        if not os.path.isdir(str(classifier_dir)):
            raise FileNotFoundError(f"classifier_model_dir={classifier_dir} is not a directory")
        if is_jax_classifier_dir(str(classifier_dir)):
            classifier, meta = load_jax_classifier(str(classifier_dir))
            if meta.get("property") not in (None, prop):
                log.warning("classifier was trained for property %r, evaluating %r", meta["property"], prop)
        else:
            classifier = load_reference_classifier(str(classifier_dir))
    else:
        log.warning("No classifier_model_dir: using a classifier drawn from seed 0 (MAE numbers will be "
                    "meaningless; for smoke testing only)")
        classifier = EGNNClassifier(in_node_nf=5, hidden_nf=32, n_layers=2)
        init_random_weights(classifier, 0)
    return classifier.to(device).eval(), meta


def classify(classifier: EGNNClassifier, one_hot, x, node_mask, device) -> np.ndarray:
    """The classifier's normalized predictions ``[B]`` for numpy molecules."""
    with torch.inference_mode():
        args = (torch.as_tensor(np.asarray(a), dtype=torch.float32, device=device) for a in (one_hot, x, node_mask))
        return classifier(*args).float().cpu().numpy()


def main(argv=None):
    cfg, _ = parse_cli(list(sys.argv[1:] if argv is None else argv), "mol_gen_eval_conditional_qm9", __doc__)
    prop = str(cfg.get("property", "alpha"))
    cfg = apply_conditional_surgery(cfg, prop)
    exp = build_experiment(with_precision(cfg, precision_of(cfg)))
    device = device_of(cfg)
    nodes_dist = nodes_distribution_for(exp)
    evd = load_model(exp, cfg.get("generator_model_filepath") or cfg.get("ckpt_path"), device, seed=exp.seed)
    sampler = SegmentedSampler(evd, device)

    norms, props_distr = property_normalizers(build_datasets(exp), (prop,), exp.dataloader_cfg.dataset)
    mean, mad = norms[prop]["mean"], norms[prop]["mad"]
    generator = torch.Generator(device=device).manual_seed(exp.seed)
    if str(cfg.get("task", "edm")) == "qualitative" or bool(cfg.get("sweep_property_values", False)):
        return run_sweeps(cfg, exp, sampler, generator, props_distr, prop, mean, mad)
    classifier, cls_meta = load_classifier(cfg.get("classifier_model_dir"), prop, device)
    # predictions decode with the classifier's own training-time normalizer
    # when its directory carries one; targets with the generator's
    cls_mean, cls_mad = float(cls_meta.get("mean", mean)), float(cls_meta.get("mad", mad))

    rng = np.random.default_rng(exp.seed)
    batch_size = int(cfg.get("batch_size", 100))
    iterations = int(cfg.get("iterations", 100))
    num_timesteps = cfg.get("num_timesteps")
    num_timesteps = int(num_timesteps) if num_timesteps else None
    single_bucket = bool(cfg.get("single_bucket", False))
    out_dir = str(cfg.get("output_dir", "outputs/mol_gen_eval_conditional_qm9"))
    dataset_info = get_dataset_info_for(exp)

    sizes_all = nodes_dist.sample(iterations * batch_size, rng)
    if not single_bucket:
        sizes_all = np.sort(sizes_all)[::-1]
    maes = []
    for it in range(iterations):
        num_nodes = sizes_all[it * batch_size: (it + 1) * batch_size]
        pad = int(nodes_dist.max_n) if single_bucket else min(select_bucket(int(num_nodes.max()), None, 2),
                                                               int(nodes_dist.max_n))
        node_mask = make_node_mask(num_nodes, pad)
        ctx_norm = props_distr.sample_batch(num_nodes, rng)  # normalized [B, 1]
        xh = sampler.run(node_mask, generator, num_timesteps=num_timesteps,
                         context=broadcast_context(ctx_norm, node_mask))
        x, one_hot = xh[..., :3], xh[..., 3:8]
        pred = classify(classifier, one_hot, x, node_mask, device)
        target = ctx_norm[:, 0] * mad + mean
        maes.append(float(np.abs(cls_mad * pred + cls_mean - target).mean()))
        log.info("iteration %d/%d: MAE=%.4f (running %.4f)", it + 1, iterations, maes[-1], np.mean(maes))
        if cfg.get("save_molecules", False):
            from bio_diffusion_torch.chem.molecule import save_xyz_files

            save_xyz_files(os.path.join(out_dir, "molecules", f"iteration_{it}"), x, one_hot, node_mask,
                           dataset_info)

    result = {"property": prop, "mae": float(np.mean(maes)), "mae_per_iteration": maes}
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"conditional_eval_{prop}.json"), "w") as f:
        json.dump(result, f, indent=2)
    print(json.dumps({"property": prop, "mae": result["mae"]}))
    return result


SWEEP_NODES = 19


def property_sweep(sampler: SegmentedSampler, generator, props_distr, prop: str, mean: float, mad: float,
                   num_frames: int, noises=None) -> Tuple[np.ndarray, np.ndarray]:
    """One fixed-noise sweep: ``num_frames`` molecules of 19 atoms sharing
    one noise draw, conditioned on ``linspace`` over the property's range at
    19 atoms (normalized by ``mean``, ``mad``) -> ``(xh, node_mask)``.
    ``noises``: the raw draws (``[1, N, F]`` each) instead of drawing from
    ``generator``."""
    lo, hi = props_distr.distributions[prop][SWEEP_NODES]["params"]
    ctx_vals = (np.linspace(lo, hi, num_frames) - mean) / mad
    node_mask = make_node_mask(np.full(num_frames, SWEEP_NODES), SWEEP_NODES)
    context = np.broadcast_to(ctx_vals[:, None, None], (num_frames, SWEEP_NODES, 1)).astype(np.float32)
    xh = sampler.run(node_mask, generator, context=context, fix_noise=True, noises=noises)
    return xh, node_mask


def run_sweeps(cfg, exp, sampler, generator, props_distr, prop: str, mean: float, mad: float):
    """``task=qualitative``: ``num_sweeps`` property sweeps written as xyz
    files (and a GIF each where it can be rendered) -> ``{"property",
    "sweeps"}``."""
    from bio_diffusion_torch.chem.molecule import save_xyz_files
    from bio_diffusion_torch.chem.visualization import can_render, visualize_chain

    dataset_info = get_dataset_info_for(exp)
    num_frames = int(cfg.get("sweep_n_frames", 100))
    num_sweeps = int(cfg.get("num_sweeps", 10))
    out_root = str(cfg.get("output_dir", "outputs/conditional_sweeps"))
    for sweep in range(num_sweeps):
        xh, node_mask = property_sweep(sampler, generator, props_distr, prop, mean, mad, num_frames)
        out_dir = os.path.join(out_root, prop, f"sweep_{sweep}")
        # QM9 with hydrogens: the five type columns, as in the JAX package
        save_xyz_files(out_dir, xh[..., :3], xh[..., 3:8], node_mask, dataset_info, name="conditional")
        if can_render():
            visualize_chain(out_dir, dataset_info)
        log.info("sweep %d/%d written to %s", sweep + 1, num_sweeps, out_dir)
    result = {"property": prop, "sweeps": num_sweeps}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
