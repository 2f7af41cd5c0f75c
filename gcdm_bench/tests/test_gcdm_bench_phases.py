"""The split of a traced window's idle by the program's spans, on a trace
written by hand and on a real trace on the CPU."""

import pytest

from gcdm_bench import phases, trace
from gcdm_bench.tests.test_gcdm_bench_trace import ev


def test_idle_splits_exactly_among_the_innermost_spans_of_the_window_thread():
    events = [
        ev("user_annotation", trace.WINDOW, 0, 100),
        ev("kernel", "a", 0, 10, tid=7), ev("kernel", "b", 40, 10, tid=7), ev("kernel", "c", 90, 10, tid=7),
        ev("user_annotation", "trainer.step", 0, 80),
        ev("user_annotation", "step.forward", 5, 30),
        ev("user_annotation", "message_layer.forward", 20, 10),  # innermost over 20-30
        ev("user_annotation", "step.backward", 35, 7),
        ev("user_annotation", "step.ema", 42, 6),  # inside a busy stretch: no idle
        ev("user_annotation", "step.clip", 60, 10),
        ev("user_annotation", "message_layer.backward", 10, 80, tid=2),  # another thread: ignored
    ]
    p = phases.reduce_phases(events)
    assert p["window_s"] == pytest.approx(100e-6) and p["busy_s"] == pytest.approx(30e-6)
    want = {"trainer.step": 20, "step.forward": 15, "message_layer.forward": 10, "step.backward": 5,
            "step.ema": 0, "step.clip": 10}
    assert p["idle_s"].keys() == want.keys()
    for name, us in want.items():
        assert p["idle_s"][name] == pytest.approx(us * 1e-6, abs=1e-15), name
    assert p["outside_s"] == pytest.approx(10e-6)  # 80-90, under no program span
    assert sum(p["idle_s"].values()) + p["outside_s"] == pytest.approx(p["window_s"] - p["busy_s"])
    pct = {name: phases.idle_pct(p, spans) for name, spans in phases.GROUPS.items()}
    assert pct == pytest.approx({"idle_data_pct": 0.0, "idle_forward_pct": 25.0, "idle_backward_pct": 5.0,
                                 "idle_update_pct": 10.0})


def test_no_window_or_no_program_span_reads_nothing():
    assert phases.reduce_phases([ev("user_annotation", "step.clip", 0, 10)]) is None
    p = phases.reduce_phases([ev("user_annotation", trace.WINDOW, 0, 10), ev("kernel", "a", 2, 3, tid=7)])
    assert p["idle_s"] == {} and p["outside_s"] == pytest.approx(7e-6)
    assert phases.idle_pct(p, phases.GROUPS["idle_data_pct"]) is None


def test_the_third_pass_records_the_program_spans_and_no_host_operation():
    import torch

    from bio_diffusion_torch.utils.profiling import span

    def body():
        with span("trainer.data"):
            torch.ones(64, 64) @ torch.ones(64, 64)

    with phases.profiler() as events:
        body()
    names = {e["name"] for e in events if e.get("ph") == "X"}
    assert "trainer.data" in names and not any(n.startswith("aten::") for n in names)
    p = phases.third_pass(torch.device("cpu"), body)
    assert p["busy_s"] == 0 and list(p["idle_s"]) == ["trainer.data"] and p["idle_s"]["trainer.data"] > 0
