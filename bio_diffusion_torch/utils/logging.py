"""Metric logging: CSV always; JSON lines, TensorBoard, wandb, MLflow, Comet
and Neptune on request; the config tree, tag enforcement and the gradient
flow summary.

Copy of ``bio_diffusion_tpu/utils/logging.py`` (the port imports nothing of
the JAX package).  The ``logger`` config group selects the backends
(``configs/logger/*.yaml``; ``many_loggers`` is csv + tensorboard + jsonl).
A service backend whose package does not import, or whose run cannot start,
is disabled and logs one warning that names it, as the JAX package's
backends disable themselves (they do so without a word).  TensorBoard event
files are written through tensorboardX, or through
``torch.utils.tensorboard`` where only the ``tensorboard`` package is
installed; :func:`read_scalar_events` reads their scalars back without
either package.
"""

from __future__ import annotations

import csv
import glob
import json
import logging
import os
import struct
import sys
import time
from typing import Any, Dict, List, Optional, Tuple


def get_logger(name: str) -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter("[%(asctime)s][%(name)s][%(levelname)s] %(message)s"))
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
        logger.propagate = False
    return logger


log = get_logger(__name__)


def _row(metrics: Dict[str, Any], step: int, epoch: Optional[int]) -> Dict[str, Any]:
    row: Dict[str, Any] = {"step": step, "epoch": epoch, "time": time.time()}
    for k, v in metrics.items():
        try:
            row[k] = float(v)
        except (TypeError, ValueError):
            row[k] = str(v)
    return row


def _plain(v: Any) -> Any:
    """A one-element tensor as a Python float (what the JAX package's
    services get from its arrays); anything else as it is."""
    return float(v) if hasattr(v, "numel") and v.numel() == 1 else v


def _disabled(backend: str, err: BaseException) -> None:
    log.warning("logger backend %s disabled: %s: %s", backend, type(err).__name__, err)


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


def _summary_writer():
    """tensorboardX's ``SummaryWriter``, else ``torch.utils.tensorboard``'s
    (which needs the ``tensorboard`` package)."""
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        from torch.utils.tensorboard import SummaryWriter
    return SummaryWriter


class TensorBoardLogger:
    """TensorBoard event files under ``log_dir``: one scalar a metric a call
    (values that are not numbers are skipped)."""

    def __init__(self, log_dir: str):
        self.writer = None
        try:
            writer_cls = _summary_writer()
            os.makedirs(log_dir, exist_ok=True)
            self.writer = writer_cls(log_dir)
        except Exception as e:  # noqa: BLE001 - a missing package disables the backend
            _disabled("tensorboard", e)

    def log(self, metrics: Dict[str, Any], step: int, epoch: Optional[int] = None) -> None:
        if self.writer is None:
            return
        for k, v in metrics.items():
            try:
                self.writer.add_scalar(k, float(v), step)
            except (TypeError, ValueError):
                pass
        self.writer.flush()

    def finish(self) -> None:
        if self.writer is not None:
            self.writer.close()


class WandbLogger:
    """Weights & Biases (``configs/logger/wandb.yaml``)."""

    def __init__(self, project: str, name: Optional[str] = None, config: Optional[Dict] = None):
        self.run = None
        try:
            import wandb

            self.run = wandb.init(project=project, name=name, config=config)
        except Exception as e:  # noqa: BLE001
            _disabled("wandb", e)

    def log(self, metrics: Dict[str, Any], step: int, epoch: Optional[int] = None) -> None:
        if self.run is not None:
            self.run.log({k: _plain(v) for k, v in metrics.items()}, step=step)

    def finish(self) -> None:
        if self.run is not None:
            self.run.finish()


class MLflowLogger:
    """MLflow (``configs/logger/mlflow.yaml``): metric names with ``/`` as
    ``_``, numbers only."""

    def __init__(self, experiment_name: str = "bio-diffusion-tpu", tracking_uri: Optional[str] = None,
                 run_name: Optional[str] = None):
        self.mlflow = None
        try:
            import mlflow

            if tracking_uri:
                mlflow.set_tracking_uri(tracking_uri)
            mlflow.set_experiment(experiment_name)
            mlflow.start_run(run_name=run_name)
            self.mlflow = mlflow
        except Exception as e:  # noqa: BLE001
            _disabled("mlflow", e)

    def log(self, metrics: Dict[str, Any], step: int, epoch: Optional[int] = None) -> None:
        if self.mlflow is None:
            return
        clean = {}
        for k, v in metrics.items():
            try:
                clean[k.replace("/", "_")] = float(v)
            except (TypeError, ValueError):
                pass
        self.mlflow.log_metrics(clean, step=step)

    def finish(self) -> None:
        if self.mlflow is not None:
            self.mlflow.end_run()


class CometLogger:
    """Comet (``configs/logger/comet.yaml``)."""

    def __init__(self, project_name: str = "bio-diffusion-tpu", **kwargs):
        self.exp = None
        try:
            import comet_ml

            self.exp = comet_ml.Experiment(project_name=project_name, **kwargs)
        except Exception as e:  # noqa: BLE001
            _disabled("comet", e)

    def log(self, metrics: Dict[str, Any], step: int, epoch: Optional[int] = None) -> None:
        if self.exp is not None:
            self.exp.log_metrics({k: _plain(v) for k, v in metrics.items()}, step=step, epoch=epoch)

    def finish(self) -> None:
        if self.exp is not None:
            self.exp.end()


class NeptuneLogger:
    """Neptune (``configs/logger/neptune.yaml``): one series a metric."""

    def __init__(self, project: Optional[str] = None, **kwargs):
        self.run = None
        try:
            import neptune

            self.run = neptune.init_run(project=project, **kwargs)
        except Exception as e:  # noqa: BLE001
            _disabled("neptune", e)

    def log(self, metrics: Dict[str, Any], step: int, epoch: Optional[int] = None) -> None:
        if self.run is None:
            return
        for k, v in metrics.items():
            try:
                self.run[k].append(float(v), step=step)
            except (TypeError, ValueError):
                pass

    def finish(self) -> None:
        if self.run is not None:
            self.run.stop()


_LOGGER_FACTORIES = {
    "csv": lambda opts, workdir: CSVLogger(opts.get("path") or os.path.join(workdir, "metrics.csv")),
    "jsonl": lambda opts, workdir: JSONLLogger(opts.get("path") or os.path.join(workdir, "metrics.jsonl")),
    "tensorboard": lambda opts, workdir: TensorBoardLogger(
        opts.get("save_dir") or os.path.join(workdir, "tensorboard")),
    "wandb": lambda opts, workdir: WandbLogger(project=opts.get("project", "bio-diffusion-tpu"),
                                               name=opts.get("name")),
    "mlflow": lambda opts, workdir: MLflowLogger(experiment_name=opts.get("experiment_name", "bio-diffusion-tpu"),
                                                 tracking_uri=opts.get("tracking_uri")),
    "comet": lambda opts, workdir: CometLogger(project_name=opts.get("project_name", "bio-diffusion-tpu")),
    "neptune": lambda opts, workdir: NeptuneLogger(project=opts.get("project")),
}


class MetricLoggers:
    def __init__(self, *loggers):
        self.loggers = [lg for lg in loggers if lg is not None]

    def log(self, metrics: Dict[str, Any], step: int, epoch: Optional[int] = None) -> None:
        for lg in self.loggers:
            lg.log(metrics, step=step, epoch=epoch)

    def finish(self) -> None:
        """Close every backend that has something to close (event files,
        service runs)."""
        for lg in self.loggers:
            if hasattr(lg, "finish"):
                lg.finish()


def build_loggers(logger_cfg: Optional[Dict[str, Any]], workdir: str) -> MetricLoggers:
    """Metric loggers from the composed ``logger`` config group (backend name
    -> options); the CSV log ``<workdir>/metrics.csv`` is always first."""
    backends: List[Any] = [CSVLogger(os.path.join(workdir, "metrics.csv"))]
    for name, opts in (logger_cfg or {}).items():
        if name == "csv":
            continue  # always on
        factory = _LOGGER_FACTORIES.get(name)
        if factory is None:
            log.warning("unknown logger backend %r; skipping", name)
            continue
        backends.append(factory(opts if isinstance(opts, dict) else {}, workdir))
    return MetricLoggers(*backends)


def print_config_tree(cfg: Dict[str, Any], title: str = "config") -> str:
    """The composed config as a tree, printed to stderr and returned: rich's
    tree where rich imports, else indented plain text."""
    try:
        import io

        from rich.console import Console
        from rich.tree import Tree

        def fill(tree, node):
            for k, v in node.items():
                if isinstance(v, dict):
                    fill(tree.add(f"[bold]{k}[/bold]"), v)
                else:
                    tree.add(f"{k}: {v!r}")

        root = Tree(f":gear: {title}")
        fill(root, cfg)
        buf = io.StringIO()
        Console(file=buf, width=120).print(root)
        text = buf.getvalue()
    except Exception:  # noqa: BLE001 - no rich: plain text
        lines = [title]

        def fill_plain(node, indent):
            for k, v in node.items():
                if isinstance(v, dict):
                    lines.append(f"{'  ' * indent}{k}:")
                    fill_plain(v, indent + 1)
                else:
                    lines.append(f"{'  ' * indent}{k}: {v!r}")

        fill_plain(cfg, 1)
        text = "\n".join(lines) + "\n"
    print(text, file=sys.stderr)
    return text


def enforce_tags(cfg: Dict[str, Any], strict: bool = False) -> None:
    """Warn, or raise ``ValueError`` when ``strict``, if ``cfg.tags`` is
    missing, empty or ``[dev]``."""
    tags = cfg.get("tags") or []
    if not tags or tags == ["dev"]:
        msg = "no experiment tags set (cfg.tags); use tags=[...] to label runs"
        if strict:
            raise ValueError(msg)
        log.warning(msg)


def grad_flow_summary(grads: Dict[str, Any]) -> Dict[str, float]:
    """Mean absolute gradient of every weight (the gradient-vanishing
    diagnostic), biases skipped: ``grads`` maps the model's state_dict names
    to gradients (e.g. the names of ``evd.named_parameters()`` zipped with
    ``torch.autograd.grad``'s output) -> ``{reference state_dict name
    (``ddpm.`` prefix): mean |grad|}``."""
    out = {}
    for name, g in grads.items():
        name = name if name.startswith("ddpm.") else "ddpm." + name
        if "bias" in name:
            continue
        out[name] = float(g.detach().abs().double().mean())
    return out


def _varint(buf: bytes, i: int) -> Tuple[int, int]:
    value = shift = 0
    while True:
        b = buf[i]
        i += 1
        value |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return value, i


def _fields(buf: bytes):
    """(field number, wire type, value) of a protobuf message's fields."""
    i = 0
    while i < len(buf):
        key, i = _varint(buf, i)
        field, wire = key >> 3, key & 7
        if wire == 0:
            value, i = _varint(buf, i)
        elif wire == 1:
            value, i = buf[i: i + 8], i + 8
        elif wire == 2:
            n, i = _varint(buf, i)
            value, i = buf[i: i + n], i + n
        elif wire == 5:
            value, i = buf[i: i + 4], i + 4
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")
        yield field, wire, value


def read_scalar_events(log_dir: str) -> List[Tuple[int, str, float]]:
    """Every scalar of the TensorBoard event files under ``log_dir`` as
    ``(step, tag, value)`` in file order (``Event.step``, and each
    ``Summary.Value``'s ``tag`` and float32 ``simple_value``), read from the
    record format directly (no TensorBoard package needed)."""
    out = []
    for path in sorted(glob.glob(os.path.join(log_dir, "*tfevents*"))):
        with open(path, "rb") as f:
            data = f.read()
        i = 0
        while i + 12 <= len(data):
            (n,) = struct.unpack("<Q", data[i: i + 8])
            event = data[i + 12: i + 12 + n]
            i += 12 + n + 4  # length, its crc, the record, its crc
            step, values = 0, []
            for field, _, value in _fields(event):
                if field == 2:
                    step = value
                elif field == 5:  # Summary
                    for f_sum, _, v_msg in _fields(value):
                        if f_sum != 1:
                            continue
                        tag, simple = None, None
                        for f_val, wire, v in _fields(v_msg):
                            if f_val == 1:
                                tag = v.decode()
                            elif f_val == 2 and wire == 5:
                                (simple,) = struct.unpack("<f", v)
                        if tag is not None and simple is not None:
                            values.append((tag, simple))
            out.extend((step, tag, v) for tag, v in values)
    return out
