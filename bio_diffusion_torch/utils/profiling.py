"""Profiling hooks: ``torch.profiler`` traces, a step timer, a graph dump.

Port of ``bio_diffusion_tpu/utils/profiling.py``:

* ``profile_trace(log_dir)`` records host ops and, where a card is present,
  its kernels (CPU and CUDA activities) and writes a Chrome trace
  (``trace.json``, loadable in Perfetto or ``chrome://tracing``) under
  ``log_dir``; ``None`` is a no-op.  Unlike the JAX package's, a profiler
  that cannot start raises instead of warning and going on untraced.
* ``StepTimer`` times steps on the host clock, synchronizing the device it
  measures before it reads the clock.
* ``dump_computation_graph`` is the counterpart of the JAX package's jaxpr /
  HLO dump: the module tree and the op sequence of one call.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from bio_diffusion_torch.utils.logging import get_logger

log = get_logger(__name__)


def _activities():
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]):
    """Trace the block with ``torch.profiler`` into ``<log_dir>/trace.json``;
    no-op when ``log_dir`` is None or empty."""
    if not log_dir:
        yield
        return
    from torch.profiler import profile

    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=_activities())
    prof.start()  # raises where the profiler cannot start
    log.info("Profiler trace -> %s", log_dir)
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepTimer:
    """Rolling wall-clock step timer; ``stop`` synchronizes ``device`` (a
    CUDA device) before it reads the clock."""

    def __init__(self, window: int = 50, device=None):
        self.window = window
        self.device = torch.device(device) if device is not None else None
        self.times: List[float] = []
        self._t0 = None

    def _sync(self):
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self):
        self._sync()
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        self._sync()
        dt = time.perf_counter() - self._t0
        self.times.append(dt)
        if len(self.times) > self.window:
            self.times.pop(0)
        return dt

    @property
    def mean(self) -> float:
        return float(np.mean(self.times)) if self.times else float("nan")


def dump_computation_graph(fn, args, out_dir: str, name: str = "forward") -> Dict[str, str]:
    """Write ``{name}.modules.txt``, the module tree of ``fn`` (an
    ``nn.Module``; its repr otherwise), and ``{name}.ops.txt``, the ops one
    call ``fn(*args)`` runs, in order, each with its input shapes, as
    ``torch.profiler`` records them (``record_shapes=True``; no gradients).
    Returns ``{"modules": path, "ops": path}``."""
    from torch.autograd import DeviceType
    from torch.profiler import profile

    os.makedirs(out_dir, exist_ok=True)
    paths = {"modules": os.path.join(out_dir, f"{name}.modules.txt"),
             "ops": os.path.join(out_dir, f"{name}.ops.txt")}
    with open(paths["modules"], "w") as f:
        f.write(f"{fn}\n")
    with torch.no_grad(), profile(activities=_activities(), record_shapes=True) as prof:
        fn(*args)
    ops = sorted((e for e in prof.events() if e.device_type == DeviceType.CPU),
                 key=lambda e: e.time_range.start)
    with open(paths["ops"], "w") as f:
        for e in ops:
            f.write(f"{e.name} {list(e.input_shapes)}\n")
    return paths
