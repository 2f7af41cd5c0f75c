"""Typed experiment config from a composed config dict, and what it builds.

Copy of ``ExperimentConfig``, ``safe_arith``, ``build_experiment``,
``get_dataset_info_for`` and ``build_datasets`` of
``bio_diffusion_tpu/config/build.py`` (the port imports nothing of the JAX
package), and ``build_evd``, the port's model for a config.
"""

from __future__ import annotations

import ast
import dataclasses
import operator
from typing import Any, Dict

from bio_diffusion_torch.config.schema import (
    DataloaderConfig,
    DiffusionConfig,
    LayerConfig,
    ModelConfig,
    ModuleConfig,
    MPConfig,
    OptimizerConfig,
    TrainerConfig,
    from_dict,
)


@dataclasses.dataclass
class ExperimentConfig:
    model_cfg: ModelConfig
    module_cfg: ModuleConfig
    layer_cfg: LayerConfig
    diffusion_cfg: DiffusionConfig
    dataloader_cfg: DataloaderConfig
    optimizer: OptimizerConfig
    trainer: TrainerConfig
    raw: Dict[str, Any]

    @property
    def seed(self) -> int:
        return int(self.raw.get("seed", 42))


def safe_arith(text: Any):
    """AST-restricted arithmetic evaluation for scheduler config expressions
    (the safe counterpart of the reference's eval() interpolation workaround,
    src/train.py:186-196): numbers and + - * / // only."""
    ops = {
        ast.Add: operator.add, ast.Sub: operator.sub, ast.Mult: operator.mul,
        ast.FloorDiv: operator.floordiv, ast.Div: operator.truediv,
        ast.USub: operator.neg,
    }

    def ev(n):
        if isinstance(n, ast.Constant) and isinstance(n.value, (int, float)):
            return n.value
        if isinstance(n, ast.BinOp) and type(n.op) in ops:
            return ops[type(n.op)](ev(n.left), ev(n.right))
        if isinstance(n, ast.UnaryOp) and type(n.op) in ops:
            return ops[type(n.op)](ev(n.operand))
        raise ValueError(f"unsupported arithmetic expression: {text!r}")

    return ev(ast.parse(str(text), mode="eval").body)


def build_experiment(cfg: Dict[str, Any]) -> ExperimentConfig:
    model = cfg.get("model", {})
    layer_raw = dict(model.get("layer_cfg", {}))
    mp_raw = layer_raw.pop("mp_cfg", {})
    layer = from_dict(LayerConfig, layer_raw)
    layer.mp_cfg = from_dict(MPConfig, mp_raw)
    trainer_raw = dict(cfg.get("trainer", {}))
    precision = str(trainer_raw.get("precision", "fp32"))
    trainer = from_dict(TrainerConfig, trainer_raw)
    trainer.precision = precision
    if isinstance(trainer.fast_train, bool):  # YAML reads on/off as booleans
        trainer.fast_train = "on" if trainer.fast_train else "off"
    diffusion = from_dict(DiffusionConfig, model.get("diffusion_cfg", {}))
    if trainer.detect_anomaly:
        # reference trainer.detect_anomaly (configs/debug/default.yaml:33)
        diffusion.debug_invariants = True
    # scheduler arithmetic strings like "${trainer.min_epochs} // 8" arrive
    # interpolated as "50 // 8"
    opt_raw = dict(model.get("optimizer", {}))
    for k in ("lr", "step_size", "warmup_steps", "gamma"):
        v = opt_raw.get(k)
        if isinstance(v, str) and any(ch in v for ch in "+-*/ "):
            opt_raw[k] = safe_arith(v)
    return ExperimentConfig(
        model_cfg=from_dict(ModelConfig, model.get("model_cfg", {})),
        module_cfg=from_dict(ModuleConfig, model.get("module_cfg", {})),
        layer_cfg=layer,
        diffusion_cfg=diffusion,
        dataloader_cfg=from_dict(DataloaderConfig, cfg.get("datamodule", {}).get("dataloader_cfg", {})),
        optimizer=from_dict(OptimizerConfig, opt_raw),
        trainer=trainer,
        raw=cfg,
    )


POCKET_DATASETS = ("bindingmoad", "crossdock", "crossdock_full")


def get_dataset_info_for(exp: ExperimentConfig) -> Dict[str, Any]:
    """The statistics table (atom types, size histogram) of the configured
    dataset; a pocket dataset's is the joint ligand+pocket table."""
    from bio_diffusion_torch.data.dataset_info import get_dataset_info

    dl = exp.dataloader_cfg
    if dl.dataset in POCKET_DATASETS:
        from bio_diffusion_torch.data.pocket import joint_dataset_info

        return joint_dataset_info(dl.dataset)
    name = "QM9_second_half" if dl.dataset == "QM9_second_half" else (
        "GEOM" if "GEOM" in dl.dataset else "QM9")
    return get_dataset_info(name, dl.remove_h)


def build_datasets(exp: ExperimentConfig) -> Dict[str, Any]:
    """Train/valid/test ``DenseDataset``s of the configured dataset:
    ``synthetic`` (the offline stand-in), QM9 or GEOM-Drugs read from
    ``data_dir``, or synthetic joint graphs for a pocket dataset."""
    dl = exp.dataloader_cfg
    if dl.dataset == "synthetic":
        from bio_diffusion_torch.data.synthetic import synthetic_qm9_like

        return {
            "train": synthetic_qm9_like(512, seed=exp.seed),
            "valid": synthetic_qm9_like(128, seed=exp.seed + 1),
            "test": synthetic_qm9_like(128, seed=exp.seed + 2),
        }
    if dl.dataset in POCKET_DATASETS:
        # the Binding MOAD / CrossDocked structures are not in the repository:
        # synthetic joint ligand+pocket graphs of their shape stand in
        from bio_diffusion_torch.data.pocket import synthetic_pocket_joint_dataset

        counts = {"train": dl.num_train, "valid": dl.num_valid, "test": dl.num_test}
        return {split: synthetic_pocket_joint_dataset(dl.dataset, num_graphs=n if n and n > 0 else default,
                                                      seed=exp.seed + i)
                for i, ((split, n), default) in enumerate(zip(counts.items(), (512, 128, 128)))}
    if "QM9" in dl.dataset:
        from bio_diffusion_torch.data.qm9 import load_qm9_datasets

        if dl.force_download:
            raise RuntimeError("force_download: the port does not download QM9; place the files "
                               f"under {dl.data_dir}/QM9")
        return load_qm9_datasets(
            dl.data_dir, dataset=dl.dataset, remove_h=dl.remove_h, subtract_thermo=dl.subtract_thermo,
            num_pts={"train": dl.num_train, "valid": dl.num_valid, "test": dl.num_test})
    if "GEOM" in dl.dataset:
        from bio_diffusion_torch.data.geom import load_geom_datasets

        if dl.force_download:
            raise RuntimeError("force_download: the port does not download GEOM-Drugs; place the files "
                               f"under {dl.data_dir}/GEOM")
        return load_geom_datasets(dl.data_dir, remove_h=dl.remove_h, filter_size=dl.filter_molecule_size)
    raise ValueError(f"unknown dataset {dl.dataset!r}")


def build_evd(exp: ExperimentConfig, fast: str = "auto"):
    """The port's EVD with the configured denoiser on the CPU, weights not
    yet set: ``dynamics_network`` gcpnet (its packed forward where the
    configuration allows it and ``fast`` is not "off", else its module
    forward; ``fast`` "on" or "pallas" where it does not raise
    ``ValueError``, as the JAX Trainer does) or egnn (never packed: "on" or
    "pallas" raise); ``trainer.precision`` bf16 gives the bf16 network body."""
    from bio_diffusion_torch.models.diffusion import EquivariantVariationalDiffusion

    compute_dtype = "bfloat16" if exp.trainer.precision in ("bf16", "bfloat16") else None
    cfgs = (exp.model_cfg, exp.module_cfg, exp.layer_cfg, exp.diffusion_cfg, exp.dataloader_cfg)
    name = exp.diffusion_cfg.dynamics_network
    if name == "gcpnet":
        from bio_diffusion_torch.models.gcpnet import GCPNetDynamics

        dynamics = GCPNetDynamics(*cfgs, compute_dtype=compute_dtype, fast=fast)
    elif name == "egnn":
        from bio_diffusion_torch.models.egnn import EGNNDynamics

        if fast in ("on", "pallas"):
            raise ValueError(f"trainer.fast_train={fast} but the model config is not supported by the fast path")
        dynamics = EGNNDynamics(*cfgs, compute_dtype=compute_dtype)
    else:
        raise ValueError(f"Unknown dynamics network {name}")
    return EquivariantVariationalDiffusion(dynamics, exp.diffusion_cfg, exp.dataloader_cfg)
