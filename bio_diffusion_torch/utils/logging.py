"""Metric logging: CSV always, JSON lines on request.

Copy of ``get_logger``, ``CSVLogger``, ``JSONLLogger``, ``MetricLoggers`` and
``build_loggers`` of ``bio_diffusion_tpu/utils/logging.py`` (the port imports
nothing of the JAX package).  The ``logger`` config group selects the
backends; the service backends of the JAX package (tensorboard, wandb,
mlflow, comet, neptune) are not ported yet and raise (ROADMAP A13).
"""

from __future__ import annotations

import csv
import json
import logging
import os
import sys
import time
from typing import Any, Dict, List, Optional


def get_logger(name: str) -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter("[%(asctime)s][%(name)s][%(levelname)s] %(message)s"))
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
        logger.propagate = False
    return logger


def _row(metrics: Dict[str, Any], step: int, epoch: Optional[int]) -> Dict[str, Any]:
    row: Dict[str, Any] = {"step": step, "epoch": epoch, "time": time.time()}
    for k, v in metrics.items():
        try:
            row[k] = float(v)
        except (TypeError, ValueError):
            row[k] = str(v)
    return row


class CSVLogger:
    """Metrics log: one row per call, a column per metric name seen so far;
    ``rows`` keeps what was logged."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.columns: List[str] = ["step", "epoch", "time"]
        self.rows: List[Dict[str, Any]] = []

    def log(self, metrics: Dict[str, Any], step: int, epoch: Optional[int] = None) -> None:
        self.rows.append(_row(metrics, step, epoch))
        self.columns += [k for k in metrics if k not in self.columns]
        with open(self.path, "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=self.columns)
            writer.writeheader()
            writer.writerows(self.rows)


class JSONLLogger:
    """Append-only JSON-lines metrics log."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def log(self, metrics: Dict[str, Any], step: int, epoch: Optional[int] = None) -> None:
        with open(self.path, "a") as f:
            f.write(json.dumps(_row(metrics, step, epoch)) + "\n")


class MetricLoggers:
    def __init__(self, *loggers):
        self.loggers = [lg for lg in loggers if lg is not None]

    def log(self, metrics: Dict[str, Any], step: int, epoch: Optional[int] = None) -> None:
        for lg in self.loggers:
            lg.log(metrics, step=step, epoch=epoch)


def build_loggers(logger_cfg: Optional[Dict[str, Any]], workdir: str) -> MetricLoggers:
    """Metric loggers from the composed ``logger`` config group (backend name
    -> options); the CSV log ``<workdir>/metrics.csv`` is always first."""
    backends: List[Any] = [CSVLogger(os.path.join(workdir, "metrics.csv"))]
    for name, opts in (logger_cfg or {}).items():
        opts = opts if isinstance(opts, dict) else {}
        if name == "csv":
            continue  # always on
        if name == "jsonl":
            backends.append(JSONLLogger(opts.get("path") or os.path.join(workdir, "metrics.jsonl")))
        elif name in ("tensorboard", "wandb", "mlflow", "comet", "neptune"):
            raise NotImplementedError(f"logger {name!r} is not ported yet (ROADMAP A13); use csv or jsonl")
        else:
            get_logger(__name__).warning("unknown logger backend %r; skipping", name)
    return MetricLoggers(*backends)
