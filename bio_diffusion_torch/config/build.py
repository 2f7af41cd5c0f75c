"""Typed experiment config from a composed config dict.

Copy of ``ExperimentConfig``, ``safe_arith`` and ``build_experiment`` of
``bio_diffusion_tpu/config/build.py`` (the port imports nothing of the JAX
package).  The port builds its own models and data from the result
(``cli/serve.py::build_model``, ``train/loop.py``, ``data/``).
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
