"""The ``--trace 1`` run's device traces, reduced to what the per-layer
readers need.

A trace of device activity alone gives the busy time and the device
operations (:func:`device_summary`).  A trace with the host's operations
too gives the kernels of each span and what the host did while the device
sat idle (:func:`reduce`).  The benchmark marks its own spans with ``torch.profiler.record_function``:
``gcdm_bench.window`` around the traced window and ``gcdm_bench.b1``
around each call into the message layer's forward entry.  The message
layer's backward is the autograd node its forward output hangs on, which
the trace shows as ``autograd::engine::evaluate_function: <node>``.  A
kernel belongs to a span when the runtime call that launched it (linked by
the trace's correlation id) ran inside the span on the span's thread, so the
same work is found whatever kernels implement it.  Device operations are
kernels, memory copies and memory sets.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

WINDOW = "gcdm_bench.window"
B1 = "gcdm_bench.b1"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation", "python_function")


def span(name: str, on: bool):
    if not on:
        return contextlib.nullcontext()
    import torch

    return torch.profiler.record_function(name)


def profiler(host: bool):
    """The profiler of device activity, and with ``host`` of the host's operations too."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU] if host or not torch.cuda.is_available() else []
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts, record_shapes=False, with_stack=False, profile_memory=False)


def export_events(prof) -> List[Dict]:
    """The profiler's events as chrome-trace dicts (written to ``TMPDIR`` and read back)."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.remove(path)


def _union(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def _inside(spans: Sequence[Dict], launches: Sequence[Dict]) -> set:
    """Correlation ids of the launches made inside any of ``spans`` on their thread."""
    by_tid: Dict = defaultdict(list)
    for s in spans:
        by_tid[(s["pid"], s["tid"])].append((s["ts"], s["ts"] + s["dur"]))
    keys = {}
    for k, iv in by_tid.items():
        iv = _union(iv)
        keys[k] = ([a for a, _ in iv], [b for _, b in iv])
    out = set()
    for ev in launches:
        k = (ev["pid"], ev["tid"])
        if k not in keys:
            continue
        starts, ends = keys[k]
        i = bisect.bisect_right(starts, ev["ts"]) - 1
        if i >= 0 and ev["ts"] <= ends[i]:
            corr = (ev.get("args") or {}).get("correlation")
            if corr is not None:
                out.add(corr)
    return out


def _top(device: Sequence[Dict]) -> List[List]:
    by_kernel: Dict[str, float] = defaultdict(float)
    for e in device:
        by_kernel[e["name"]] += float(e["dur"]) * 1e-6
    return sorted(([k, v] for k, v in by_kernel.items()), key=lambda kv: -kv[1])[:10]


def device_summary(events: List[Dict], window_s: float) -> Optional[Dict]:
    """A trace of device activity alone over a window of ``window_s`` host
    seconds -> ``window_s``, ``busy_s``, ``device_ops`` and the ten device
    operations that took most time (``top``), or None where it holds none."""
    device = [e for e in events if e.get("ph") == "X" and "dur" in e and e.get("cat") in DEVICE_CATS]
    if not device:
        return None
    busy = _union((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in device)
    return {"window_s": float(window_s), "busy_s": sum(b - a for a, b in busy) * 1e-6,
            "device_ops": len(device), "top": _top(device)}


def reduce(events: List[Dict], backward_nodes: Iterable[str] = ()) -> Optional[Dict]:
    """-> ``window_s``, ``busy_s``, ``device_ops``, ``b1_s``, ``b2_s`` and the
    breakdown, or None where the trace holds no window or no device work."""
    events = [e for e in events if e.get("ph") == "X" and "dur" in e]
    windows = [e for e in events if e.get("cat") == "user_annotation" and e.get("name") == WINDOW]
    if not windows:
        return None
    win = windows[0]
    w0, w1 = float(win["ts"]), float(win["ts"]) + float(win["dur"])
    device = [e for e in events if e.get("cat") in DEVICE_CATS and e["ts"] < w1 and e["ts"] + e["dur"] > w0]
    if not device:
        return None
    busy = _union((max(w0, float(e["ts"])), min(w1, float(e["ts"]) + float(e["dur"]))) for e in device)
    launches = [e for e in events if e.get("cat") in LAUNCH_CATS]
    b1_spans = [e for e in events if e.get("cat") == "user_annotation" and e.get("name") == B1]
    names = {f"autograd::engine::evaluate_function: {n}" for n in backward_nodes}
    b2_spans = [e for e in events if e.get("cat") == "cpu_op" and e.get("name") in names]

    def device_time(spans) -> float:
        corr = _inside(spans, launches)
        return sum(float(e["dur"]) for e in device if (e.get("args") or {}).get("correlation") in corr) * 1e-6

    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": sum(b - a for a, b in busy) * 1e-6,
        "device_ops": len(device),
        "b1_s": device_time(b1_spans) if b1_spans else None,
        "b2_s": device_time(b2_spans) if b2_spans else None,
        "breakdown": {"device_ops": _top(device), "idle_gaps": idle_gaps(events, busy, win)},
    }


def idle_gaps(events: List[Dict], busy: List[Tuple[float, float]], win: Dict) -> List[List]:
    """Seconds the device sat idle inside the window, by the innermost host
    operation running on the window's thread at each gap's middle."""
    w0, w1 = float(win["ts"]), float(win["ts"]) + float(win["dur"])
    gaps, t = [], w0
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if w1 > t:
        gaps.append((t, w1))
    host = sorted((e for e in events if e.get("cat") in HOST_CATS and e["tid"] == win["tid"]
                   and e["pid"] == win["pid"]), key=lambda e: e["ts"])
    starts = [float(e["ts"]) for e in host]
    by_name: Dict[str, float] = defaultdict(float)
    for a, b in gaps:
        mid = 0.5 * (a + b)
        name = "host: between operations"
        # the innermost operation covering ``mid`` starts latest among those that cover it
        last = bisect.bisect_right(starts, mid) - 1
        for i in range(last, max(-1, last - 500), -1):
            if starts[i] + float(host[i]["dur"]) >= mid:
                name = host[i]["name"]
                break
        by_name[name] += (b - a) * 1e-6
    return sorted(([k, v] for k, v in by_name.items()), key=lambda kv: -kv[1])[:10]
