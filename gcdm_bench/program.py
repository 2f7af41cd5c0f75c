"""What every driver shares: the run's inputs, the program built from a
configuration file, the weights made from the seed, the plain reference's
model, the device's clocks and peaks, and the traced passes.

A driver (``drivers/<kind>.py``, chosen by the traffic file's ``kind``)
builds the program from the configuration file, makes the weights and the
traffic from the seed, warms up every shape the traffic reaches (set-up),
runs the measured window, reads the peak memory, frees the program, and
then judges what the window produced against the plain reference
(``reference/gcdm.py``), on the draws the benchmark made and handed to both
sides.  It leaves in ``run.out``: ``setup_s``, ``window_s``,
``peak_bytes``, ``attempted``, ``failed``, ``e2e`` (the end-to-end
metrics), ``readings`` (each compared number, and with ``Run.control`` the
control's), ``trace`` and ``ctx`` (what the per-layer readers read).
"""

from __future__ import annotations

import contextlib
import sys
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

import torch

from gcdm_bench import trace, yardstick
from gcdm_bench.harness import make_weights
from gcdm_bench.reference import gcdm as ref


@dataclass
class Run:
    """One run's inputs and what it hands to the readers."""

    workload: str
    config: Dict
    spec: Dict  # the traffic file
    seed: int
    seconds: float
    traced: bool
    device: torch.device
    t_start: float  # process start, for setup_s
    control: bool = False  # also read the control (the reference in TF32)
    fault: Optional[str] = None  # plant a fault in the timed path (the harness's own tests)
    out: Dict = field(default_factory=dict)


def num_features(config: Dict) -> int:
    return 3 + config["num_atom_types"] + int(config["include_charges"])


def experiment(config: Dict, seed: int, spec: Optional[Dict] = None):
    """The program's experiment config: the configuration file laid over the
    named experiment's YAML, with a training traffic file's batch size and
    data order."""
    from bio_diffusion_torch.config.build import build_experiment
    from bio_diffusion_torch.config.loader import default_config_dir, load_config

    cfg = load_config(default_config_dir(), "train", [f"experiment={config['experiment']}"])
    model = cfg["model"]
    for key in ("model_cfg", "module_cfg", "diffusion_cfg", "optimizer"):
        model.setdefault(key, {}).update(config[key])
    layer = dict(config["layer_cfg"])
    model["layer_cfg"].setdefault("mp_cfg", {}).update(layer.pop("mp_cfg"))
    model["layer_cfg"].update(layer)
    dl = cfg["datamodule"]["dataloader_cfg"]
    dl.update(config["dataloader_cfg"])
    if spec is not None:
        dl["batch_size"] = int(spec["batch_size"])
        dl["shuffle"] = bool(spec.get("shuffle", True))
    cfg.setdefault("trainer", {}).update(config["trainer"])
    cfg["seed"] = int(seed) % (1 << 31)
    return build_experiment(cfg)


def reference_dynamics(config: Dict, device) -> ref.Dynamics:
    with torch.device(device):
        return ref.Dynamics(config["model_cfg"], config["module_cfg"], config["layer_cfg"],
                            config["num_atom_types"] + int(config["include_charges"]))


def weights(config: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The run's weights under the published module tree's names."""
    shapes = {f"dynamics_network.{k}": tuple(v.shape)
              for k, v in reference_dynamics(config, "meta").named_parameters()}
    return make_weights(shapes, seed, device, config.get("weight_scales"))


def load_reference(config: Dict, state: Dict[str, torch.Tensor], device) -> ref.Dynamics:
    net = reference_dynamics(config, device)
    net.load_state_dict({k[len("dynamics_network."):]: v for k, v in state.items()}, strict=True)
    return net


@contextlib.contextmanager
def fp32_reference(tf32: bool):
    """The reference's precision: float32 with TF32 off, or TF32 for the control."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def reset_peak(device) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def peak_bytes(device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


@contextlib.contextmanager
def message_layer_spans(backward_nodes: set):
    """Mark each call into the message layer's forward entry
    (``ops/message_layer.py::message_layer``), in every module that has
    bound it, and note the autograd node its backward runs as."""
    from bio_diffusion_torch.ops import message_layer as ops

    inner = ops.message_layer

    def marked(*args, **kwargs):
        with trace.span(trace.B1, True):
            out = inner(*args, **kwargs)
        if out[0].grad_fn is not None:
            backward_nodes.add(out[0].grad_fn.name())
        return out

    holders = [m for m in list(sys.modules.values()) if m is not None and vars(m).get("message_layer") is inner]
    for m in holders:
        m.message_layer = marked
    try:
        yield
    finally:
        for m in holders:
            m.message_layer = inner


def traced_passes(run: Run, body: Callable[[], None], backward_nodes: set) -> Optional[Dict]:
    """Two more passes of ``body`` after the window, each under the profiler.
    The first records device activity alone, so the profiler adds little
    host work: busy time, idle share and device operations come from it,
    over the host clock's window.  The second records the host's operations
    too: the device time of the kernels launched inside the message layer's
    forward and backward (found by span), and what the host did in each
    idle gap."""
    prof = trace.profiler(host=False)
    with prof:
        sync(run.device)
        t0 = time.perf_counter()
        body()
        sync(run.device)
        window_s = time.perf_counter() - t0
    device = trace.device_summary(trace.export_events(prof), window_s)
    prof = trace.profiler(host=True)
    t0 = time.perf_counter()
    with message_layer_spans(backward_nodes), prof:
        with trace.span(trace.WINDOW, True):
            body()
            sync(run.device)
    host_s = time.perf_counter() - t0
    spans = trace.reduce(trace.export_events(prof), backward_nodes)
    print(f"traced passes: {window_s:.4f} s with device activity, {host_s:.4f} s with host operations too",
          file=sys.stderr)
    if device is None or spans is None:
        return None
    return {"window_s": device["window_s"], "busy_s": device["busy_s"], "device_ops": device["device_ops"],
            "b1_s": spans["b1_s"], "b2_s": spans["b2_s"],
            "breakdown": {"device_ops": device["top"], "idle_gaps": spans["breakdown"]["idle_gaps"]}}


def bound_s(run: Run, flops: float, nbytes: float) -> Optional[float]:
    """The least time the card could take: operations over the configuration's
    precision peak or bytes over the memory's, whichever is larger."""
    peak = peak_flops(run)
    if peak is None:
        return None
    hbm = yardstick.peaks(torch.cuda.get_device_name(run.device))["hbm_bytes_per_s"]
    return max(flops / peak, nbytes / hbm)


def peak_flops(run: Run) -> Optional[float]:
    if run.device.type != "cuda":
        return None
    peak = yardstick.peaks(torch.cuda.get_device_name(run.device))
    return None if peak is None else peak["flops"][run.config["precision"]]
