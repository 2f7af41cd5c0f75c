"""Hierarchical YAML config composition (Hydra-equivalent subset).

Copy of ``bio_diffusion_tpu/config/loader.py`` (the port imports nothing of
the JAX package); both read the repository's shared ``configs/`` tree.
Reproduces the semantics the reference's config tree relies on
(configs/*.yaml with Hydra 1.2): ``defaults`` lists composing group files,
``# @package _global_`` experiment overlays, ``${a.b}`` interpolation, and
dotted command-line overrides — without the Hydra dependency (not in this
image).  The composed result is a plain nested dict; ``build.py`` maps it
onto the typed dataclass schema.
"""

from __future__ import annotations

import copy
import os
import re
from typing import Any, Dict, List, Optional, Sequence

import yaml

_INTERP_RE = re.compile(r"\$\{([^}]+)\}")


def _read_yaml(path: str) -> Dict[str, Any]:
    with open(path) as f:
        data = yaml.safe_load(f) or {}
    if not isinstance(data, dict):
        raise ValueError(f"Config file {path} must contain a mapping")
    return data


def _is_global_package(path: str) -> bool:
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line.startswith("# @package"):
                return "_global_" in line
            if line and not line.startswith("#"):
                break
    return False


def deep_merge(base: Dict[str, Any], overlay: Dict[str, Any]) -> Dict[str, Any]:
    out = dict(base)
    for k, v in overlay.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def _compose_file(config_dir: str, rel_path: str, group: Optional[str] = None) -> Dict[str, Any]:
    """Load one config file, resolving its own defaults list (pre-merge)."""
    path = os.path.join(config_dir, rel_path)
    raw = _read_yaml(path)
    defaults = raw.pop("defaults", None)

    composed: Dict[str, Any] = {}
    self_merged = False
    if defaults:
        for entry in defaults:
            if entry == "_self_":
                composed = deep_merge(composed, raw)
                self_merged = True
                continue
            if isinstance(entry, str):
                # plain include from the same group dir
                inc = _compose_file(config_dir, os.path.join(os.path.dirname(rel_path), _with_ext(entry)))
                composed = deep_merge(composed, inc)
                continue
            (key, value), = entry.items()
            if value is None:
                continue
            override = False
            if key.startswith("override "):
                key = key[len("override "):]
                override = True
            optional = False
            if key.startswith("optional "):
                key = key[len("optional "):]
                optional = True
            key = key.strip()
            grp = key.lstrip("/")
            grp_dir = grp if key.startswith("/") else os.path.join(os.path.dirname(rel_path), grp)
            sub_rel = os.path.join(grp_dir, _with_ext(value))
            if optional and not os.path.exists(os.path.join(config_dir, sub_rel)):
                continue
            sub = _compose_file(config_dir, sub_rel, group=grp)
            if _is_global_package(os.path.join(config_dir, sub_rel)):
                composed = deep_merge(composed, sub)
            else:
                leaf = grp.split(os.sep)[-1].split("/")[-1]
                composed = deep_merge(composed, {leaf: sub})
    if not self_merged:
        composed = deep_merge(composed, raw)
    return composed


def _with_ext(name: str) -> str:
    return name if name.endswith((".yaml", ".yml")) else name + ".yaml"


def _set_dotted(cfg: Dict[str, Any], dotted: str, value: Any):
    keys = dotted.split(".")
    node = cfg
    for k in keys[:-1]:
        node = node.setdefault(k, {})
        if not isinstance(node, dict):
            raise ValueError(f"Cannot set {dotted}: {k} is not a mapping")
    node[keys[-1]] = value


def _get_dotted(cfg: Dict[str, Any], dotted: str) -> Any:
    node = cfg
    for k in dotted.split("."):
        node = node[k]
    return node


def _resolve_interpolations(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """Resolve ${a.b} references (absolute paths into the composed tree)."""

    def resolve_value(v, depth=0):
        if depth > 20:
            raise ValueError("Interpolation depth exceeded (cycle?)")
        if isinstance(v, str):
            full = _INTERP_RE.fullmatch(v.strip())
            if full:
                target = _get_dotted(cfg, full.group(1).lstrip("."))
                return resolve_value(target, depth + 1)
            if _INTERP_RE.search(v):
                return _INTERP_RE.sub(
                    lambda m: str(resolve_value(_get_dotted(cfg, m.group(1).lstrip(".")), depth + 1)),
                    v,
                )
        if isinstance(v, dict):
            return {k: resolve_value(x, depth + 1) for k, x in v.items()}
        if isinstance(v, list):
            return [resolve_value(x, depth + 1) for x in v]
        return v

    return {k: resolve_value(v) for k, v in cfg.items()}


def parse_override_value(text: str) -> Any:
    try:
        return yaml.safe_load(text)
    except yaml.YAMLError:
        return text


def load_config(
    config_dir: str,
    name: str,
    overrides: Sequence[str] = (),
) -> Dict[str, Any]:
    """Compose ``<config_dir>/<name>.yaml`` with group selections + overrides.

    Overrides: ``a.b=value`` sets a leaf; ``group=name`` (for group dirs like
    ``experiment``, ``datamodule``, ``model``, ``trainer``) re-selects a group
    file, with ``experiment=...`` merged at global level like the reference's
    ``# @package _global_`` experiment configs.
    """
    cfg = _compose_file(config_dir, _with_ext(name))

    group_dirs = {
        d for d in os.listdir(config_dir) if os.path.isdir(os.path.join(config_dir, d))
    }

    leaf_overrides: List[str] = []
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"Override '{ov}' must be key=value")
        key, value = ov.split("=", 1)
        if key in group_dirs and "." not in key:
            sub_rel = os.path.join(key, _with_ext(value))
            sub = _compose_file(config_dir, sub_rel, group=key)
            if _is_global_package(os.path.join(config_dir, sub_rel)):
                cfg = deep_merge(cfg, sub)
            else:
                cfg = deep_merge(cfg, {key: sub})
        else:
            leaf_overrides.append(ov)

    for ov in leaf_overrides:
        key, value = ov.split("=", 1)
        _set_dotted(cfg, key, parse_override_value(value))

    return _resolve_interpolations(cfg)


def default_config_dir() -> str:
    """The repo-level configs/ directory."""
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    return os.path.join(here, "configs")
