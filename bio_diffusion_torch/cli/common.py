"""Shared CLI plumbing: argument parsing, the device, model loading.

Port of ``bio_diffusion_tpu/cli/common.py`` (``parse_cli``, ``load_model``,
``nodes_distribution_for``, and ``inference_devices`` for its
``inference_mesh``: the inference CLIs run on one card unless
``inference_devices=K`` or ``all`` splits each batch over K cards).
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Tuple

import torch

from bio_diffusion_torch.config.build import ExperimentConfig, build_evd, get_dataset_info_for
from bio_diffusion_torch.config.loader import default_config_dir, load_config
from bio_diffusion_torch.models.distributions import NumNodesDistribution
from bio_diffusion_torch.parallel.distributed import inference_devices  # noqa: F401 (re-exported for the CLIs)
from bio_diffusion_torch.train.checkpoints import load_checkpoint
from bio_diffusion_torch.train.torch_import import (
    init_random_weights,
    load_reference_checkpoint,
    load_reference_state_dict,
)
from bio_diffusion_torch.utils.logging import get_logger

log = get_logger(__name__)


def parse_cli(argv: List[str], config_name: str, usage: Optional[str] = None
              ) -> Tuple[Dict[str, Any], Dict[str, str]]:
    """Split args into ``key=value`` config overrides and ``--flags``; compose
    the config (``--config-dir``, ``--config-name`` pick another one).

    ``--help`` prints ``usage`` (the entry point's docstring) and the composed
    default config (every key is overridable as ``key=value``)."""
    config_dir = default_config_dir()
    overrides, flags = [], {}
    for arg in argv:
        if arg.startswith("--"):
            k, _, v = arg[2:].partition("=")
            flags[k] = v
            if k == "config-dir":
                config_dir = v
            elif k == "config-name":
                config_name = v
        else:
            overrides.append(arg)
    if "help" in flags or "-h" in overrides:
        _print_help(config_dir, config_name, usage)
        raise SystemExit(0)
    return load_config(config_dir, config_name, overrides), flags


def _print_help(config_dir: str, config_name: str, usage: Optional[str]) -> None:
    import yaml

    if usage:
        print(usage.strip())
    print(f"\nDefault config ({config_name}.yaml; any key is a 'key=value' override,"
          f"\ngroups like datamodule/model/logger/experiment re-select group files):\n")
    print(yaml.safe_dump(load_config(config_dir, config_name, []), default_flow_style=False, sort_keys=False))


def device_of(cfg: Dict[str, Any]) -> torch.device:
    """The ``device`` config key (default ``cuda``); a CUDA device that is
    not there raises: there is no fallback to the CPU."""
    device = torch.device(str(cfg.get("device", "cuda")))
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device=cuda but no CUDA device is available (there is no CPU fallback)")
    return device


def precision_of(cfg: Dict[str, Any], default: str = "fp32") -> str:
    """An explicit ``trainer.precision`` wins over the top-level ``precision``
    key -> "bf16" or "fp32"."""
    trainer = cfg.get("trainer")
    explicit = trainer.get("precision") if isinstance(trainer, dict) else None
    value = explicit if explicit is not None else cfg.get("precision", default)
    return "bf16" if str(value).lower() in ("bf16", "bfloat16") else "fp32"


def with_precision(cfg: Dict[str, Any], precision: str) -> Dict[str, Any]:
    """``cfg`` with ``trainer.precision`` set, which ``build_evd`` reads."""
    return {**cfg, "trainer": {**(cfg.get("trainer") or {}), "precision": precision}}


def load_model(exp: ExperimentConfig, ckpt_path: Optional[str], device, prefer_ema: bool = True,
               seed: int = 0):
    """The port's EVD on ``device`` in eval mode, weights from any supported
    checkpoint form:

      * a port checkpoint directory written by the Trainer (the newest
        step's EMA weights, or with ``prefer_ema=False`` its raw weights)
      * any file in the reference Lightning layout: a reference
        ``.ckpt``/``.pt``/``.pth``, a port ``step_<n>.pt`` (its raw weights)
        or a params file written by ``train.checkpoints.save_params``
      * None: weights drawn from ``seed`` (with a warning)
    """
    evd = build_evd(exp)
    if ckpt_path is None:
        log.warning("No ckpt_path given: using weights drawn from seed %d", seed)
        init_random_weights(evd, seed)
    elif os.path.isdir(ckpt_path):
        payload = load_checkpoint(ckpt_path)
        load_reference_state_dict(evd, payload["ema_state_dict" if prefer_ema else "state_dict"])
        log.info("Restored %s weights of checkpoint step %d from %s", "EMA" if prefer_ema else "raw",
                 payload["step"], ckpt_path)
    else:
        log.info("Importing reference-layout torch checkpoint %s", ckpt_path)
        load_reference_checkpoint(evd, str(ckpt_path))
    return evd.to(device).eval()


def nodes_distribution_for(exp: ExperimentConfig) -> NumNodesDistribution:
    info = get_dataset_info_for(exp)
    return NumNodesDistribution({int(k): int(v) for k, v in info["n_nodes"].items()})

