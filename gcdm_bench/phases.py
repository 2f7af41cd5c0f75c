"""Where the card sat idle in a traced window, by what the program was doing.

The program marks its own work with spans (``bio_diffusion_torch/utils/
profiling.py::span``: ``trainer.data``, ``step.forward``, ...).  A pass
under :func:`profiler` records the card's activity and those spans and
nothing else: no host operation, so the host runs about as fast as under
the profiler of device activity alone, and the idle it finds is the
program's, not the profiler's.  :func:`reduce_phases` splits each idle
interval of the card inside the ``gcdm_bench.window`` span, by exact
overlap, among the innermost program spans on the window's thread; idle
under no program span is ``outside_s``.  :data:`GROUPS` gathers the spans
of the training step into the four phases the idle is reported in, and
:func:`idle_pct` reads one.

    python3 gcdm_bench/phases.py --workload qm9_train_b64 --seed <n> --seconds <s>

runs a cell as ``gcdm_bench/run.py --trace 1`` does and then, after its two
traced passes, a third: one more epoch (or sampler batch) under
:func:`profiler`.  Its last line of standard output is one JSON object: the
cell's per-layer metrics and breakdown, both passes' windows, the split of
the third pass's idle (``phases``), each group's share of the window
(``idle_pct``), and, read on the second pass's trace, the device seconds
of the kernels launched inside the program's ``message_layer.forward`` and
``message_layer.backward`` spans beside ``b1_s`` and ``b2_s``, and the same
split of that pass's idle (``phases_pass2``: the host's operations traced
too, so its idle is mostly the profiler's).
"""

from __future__ import annotations

import contextlib
import json
import sys
import types
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from gcdm_bench import trace  # noqa: E402

GROUPS = {
    "idle_data_pct": ("trainer.data", "trainer.h2d"),
    "idle_forward_pct": ("step.forward", "message_layer.forward"),
    "idle_backward_pct": ("step.backward", "message_layer.backward", "message_layer.backward.chunk"),
    "idle_update_pct": ("step.clip", "step.optimizer", "step.ema", "step.reduce"),
}
MESSAGE_LAYER = ("message_layer.forward", "message_layer.backward")


@contextlib.contextmanager
def profiler():
    """Record the card's activity and the program's spans (the record scope
    limited to user annotations) over the block -> a list that holds, once
    the block ends, the trace's events as chrome-trace dicts."""
    import torch
    from torch._C._autograd import _disable_profiler, _enable_profiler, _prepare_profiler
    from torch._C._profiler import ProfilerActivity, ProfilerConfig, ProfilerState, RecordScope, _ExperimentalConfig

    acts = {ProfilerActivity.CPU}
    if torch.cuda.is_available():
        acts.add(ProfilerActivity.CUDA)
    cfg = ProfilerConfig(ProfilerState.KINETO, False, False, False, False, False, _ExperimentalConfig())
    _prepare_profiler(cfg, acts)
    _enable_profiler(cfg, acts, {RecordScope.USER_SCOPE})
    events: List[Dict] = []
    try:
        yield events
    finally:
        result = _disable_profiler()
        events.extend(trace.export_events(types.SimpleNamespace(export_chrome_trace=result.save)))


def _innermost(spans: Sequence[Tuple[float, float, str]]) -> List[Tuple[float, float, str]]:
    """Spans of one thread, which nest -> ``(start, end, name)`` pieces in
    time order, each under the innermost span open over it."""
    bounds = []
    for k, (a, b, _) in enumerate(spans):
        bounds += [(a, 1, -b, k), (b, 0, 0.0, k)]  # at one time: ends first, then outer starts first
    out, stack, t = [], [], None
    for time, opens, _, k in sorted(bounds):
        if stack and time > t:
            out.append((t, time, spans[stack[-1]][2]))
        t = time
        if opens:
            stack.append(k)
        else:
            stack.remove(k)
    return out


def reduce_phases(events: Iterable[Dict]) -> Optional[Dict]:
    """-> ``window_s``, ``busy_s``, ``idle_s`` (idle seconds by the name of
    the innermost program span over them; every program span's name
    present, 0.0 where the card had no idle under it) and ``outside_s``
    (idle under no program span), or None where the trace holds no window."""
    events = [e for e in events if e.get("ph") == "X" and "dur" in e]
    win = next((e for e in events if e.get("cat") == "user_annotation" and e.get("name") == trace.WINDOW), None)
    if win is None:
        return None
    w0, w1 = float(win["ts"]), float(win["ts"]) + float(win["dur"])
    busy = trace._union((max(w0, float(e["ts"])), min(w1, float(e["ts"]) + float(e["dur"])))
                        for e in events if e.get("cat") in trace.DEVICE_CATS
                        and e["ts"] < w1 and e["ts"] + e["dur"] > w0)
    gaps, t = [], w0
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if w1 > t:
        gaps.append((t, w1))
    spans = [(max(w0, float(e["ts"])), min(w1, float(e["ts"]) + float(e["dur"])), e["name"]) for e in events
             if e.get("cat") == "user_annotation" and e["name"] != trace.WINDOW
             and (e["pid"], e["tid"]) == (win["pid"], win["tid"]) and e["ts"] < w1 and e["ts"] + e["dur"] > w0]
    idle = {name: 0.0 for _, _, name in spans}
    outside, i = 0.0, 0
    pieces = _innermost(spans)
    for a, b in gaps:
        covered = 0.0
        while i < len(pieces) and pieces[i][1] <= a:
            i += 1
        j = i
        while j < len(pieces) and pieces[j][0] < b:
            part = min(b, pieces[j][1]) - max(a, pieces[j][0])
            if part > 0:
                idle[pieces[j][2]] += part * 1e-6
                covered += part
            j += 1
        outside += (b - a - covered) * 1e-6
    return {"window_s": (w1 - w0) * 1e-6, "busy_s": sum(b - a for a, b in busy) * 1e-6, "idle_s": idle,
            "outside_s": outside}


def idle_pct(phases: Optional[Dict], spans: Iterable[str]) -> Optional[float]:
    """Percent of the window in which the card sat idle while the innermost
    program span was one of ``spans``; None where the pass found no program
    span."""
    if not phases or not phases["idle_s"]:
        return None
    return 100.0 * sum(phases["idle_s"].get(s, 0.0) for s in spans) / phases["window_s"]


def span_device_s(events: Iterable[Dict], names: Iterable[str]) -> Dict[str, Optional[float]]:
    """Device seconds of the kernels, copies and sets launched inside the
    program's spans of each name (on the span's own thread), or None for a
    name the trace does not hold."""
    events = [e for e in events if e.get("ph") == "X" and "dur" in e]
    launches = [e for e in events if e.get("cat") in trace.LAUNCH_CATS]
    device = [e for e in events if e.get("cat") in trace.DEVICE_CATS]
    out = {}
    for name in names:
        spans = [e for e in events if e.get("cat") == "user_annotation" and e.get("name") == name]
        corr = trace._inside(spans, launches)
        out[name] = (sum(float(e["dur"]) for e in device if (e.get("args") or {}).get("correlation") in corr)
                     * 1e-6 if spans else None)
    return out


def third_pass(device, body: Callable[[], None]) -> Optional[Dict]:
    """One more ``body()`` under :func:`profiler`, inside the window's span
    -> :func:`reduce_phases` of its trace."""
    from gcdm_bench.program import sync

    with profiler() as events:
        with trace.span(trace.WINDOW, True):
            body()
            sync(device)
    return reduce_phases(events)


def measure(args) -> Dict:
    """``run.execute`` of a ``--trace 1`` run with :func:`third_pass` after
    its two traced passes -> the tool's line."""
    from gcdm_bench import program, run

    args.trace = 1
    seen: Dict = {}
    passes, reduce = program.traced_passes, trace.reduce

    def noting_spans(events, backward_nodes=()):
        seen["spans_s"], seen["pass2"] = span_device_s(events, MESSAGE_LAYER), reduce_phases(events)
        return reduce(events, backward_nodes)

    def with_third_pass(r, body, backward_nodes):
        summary = passes(r, body, backward_nodes)
        seen["phases"] = third_pass(r.device, body)
        print(f"traced pass 3: {seen['phases']['window_s']:.4f} s with device activity and the program's spans",
              file=sys.stderr)
        seen["b_s"] = None if summary is None else {"b1_s": summary["b1_s"], "b2_s": summary["b2_s"]}
        return summary

    program.traced_passes, trace.reduce = with_third_pass, noting_spans
    try:
        res = run.execute(args)
    finally:
        program.traced_passes, trace.reduce = passes, reduce
    phases = seen.get("phases")
    return {"workload": args.workload, "seed": args.seed, "correct": res["correct"], "device": res["device"],
            "metrics": res["metrics"], "breakdown": res["breakdown"], "phases": phases,
            "idle_pct": {name: idle_pct(phases, spans) for name, spans in GROUPS.items()},
            "message_layer_s": seen.get("spans_s"), "b_s": seen.get("b_s"), "phases_pass2": seen.get("pass2")}


def main(argv=None) -> int:
    from gcdm_bench import run

    args = run.parse(argv)
    run.pin_threads()
    print(json.dumps(measure(args)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
