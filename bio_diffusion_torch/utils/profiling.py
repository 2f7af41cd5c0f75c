"""Profiling hooks: the program's spans, ``torch.profiler`` traces, a graph dump.

Port of ``bio_diffusion_tpu/utils/profiling.py``:

* ``span(name)`` marks a piece of the program's work for a profiler that
  runs: ``torch.profiler.record_function(name)``, so the span shares the
  clock of the card's events in the same trace.  With no profiler running
  it is one C call and a shared no-op.  The spans, each around exactly the
  work it names:

  ================================  ==============================================
  ``trainer.epoch``                 ``train/loop.py::Trainer.train_epoch``, the whole call
  ``trainer.data``                  each ``next()`` on the epoch's batch iterator:
                                    collation (``data/native_loader.py``)
  ``trainer.h2d``                   each batch's ``.to(device)``
  ``trainer.step``                  each call of the train step
  ``trainer.readback``              the epoch's one device-to-host read of its step
                                    metrics, the finiteness check and the loggers
  ``step.forward``                  ``train/step.py``: the loss, once a micro-batch
  ``step.backward``                 ``torch.autograd.grad`` of it, once a micro-batch
  ``step.reduce``                   data-parallel only: the all-reduce of the
                                    gradients and metrics, or on a model axis
                                    ``ModelShards.reduce_gradients``
  ``step.clip``                     ``adaptive_clip``
  ``step.optimizer``                AMSGrad's update, ``TrainState.apply_gradients``
  ``step.ema``                      ``TrainState.update_ema``
  ``sampler.prior``                 ``train/sampling.py::SegmentedSampler.run``: the
                                    draws and each replica's ``init_sample_noise``
  ``sampler.step``                  each reverse step over all replicas, the copy
                                    of a kept frame included
  ``sampler.decode``                ``decode_sample`` on each replica
  ``sampler.readback``              the result's gather to the host and the kept
                                    frames' copy
  ``message_layer.forward``         each call of ``ops/message_layer.py::message_layer``
  ``message_layer.backward``        each ``MessageLayerFunction.backward`` (on a
                                    card, on autograd's device thread)
  ``message_layer.backward.chunk``  each kernel call of that backward on a card,
                                    one a chunk of whole molecules
  ================================  ==============================================

* ``profile_trace(log_dir)`` records host ops and, where a card is present,
  its kernels (CPU and CUDA activities) and writes a Chrome trace
  (``trace.json``, loadable in Perfetto or ``chrome://tracing``) under
  ``log_dir``; ``None`` is a no-op.  Unlike the JAX package's, a profiler
  that cannot start raises instead of warning and going on untraced.
* ``dump_computation_graph`` is the counterpart of the JAX package's jaxpr /
  HLO dump: the module tree and the op sequence of one call.
"""

from __future__ import annotations

import contextlib
import os
from typing import Dict, Optional

import torch
from torch._C._autograd import _profiler_enabled

from bio_diffusion_torch.utils.logging import get_logger

log = get_logger(__name__)

_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """``torch.profiler.record_function(name)`` while a profiler runs, else
    one shared no-op context."""
    if not _profiler_enabled():
        return _NO_SPAN
    return torch.profiler.record_function(name)


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
