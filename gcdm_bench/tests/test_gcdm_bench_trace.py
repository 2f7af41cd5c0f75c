"""The reduction of a device trace, on a trace written by hand."""

from gcdm_bench import trace


def ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_spans_find_their_kernels_by_correlation():
    events = [
        ev("user_annotation", trace.WINDOW, 0, 100),
        ev("user_annotation", trace.B1, 10, 20),
        ev("cuda_runtime", "cudaLaunchKernel", 12, 1, corr=1),
        ev("cuda_runtime", "cudaLaunchKernel", 40, 1, corr=2),
        ev("cpu_op", "autograd::engine::evaluate_function: MessageLayerFunctionBackward", 50, 30, tid=2),
        ev("cuda_runtime", "cudaLaunchKernel", 55, 1, tid=2, corr=3),
        ev("cuda_runtime", "cudaLaunchKernel", 56, 1, tid=2, corr=4),
        ev("kernel", "b1_kernel", 15, 10, tid=7, corr=1),
        ev("kernel", "other", 45, 5, tid=7, corr=2),
        ev("kernel", "b2_rows", 60, 10, tid=7, corr=3),
        ev("gpu_memcpy", "copy", 70, 5, tid=7, corr=4),
        ev("gpu_user_annotation", trace.WINDOW, 0, 100, tid=7),
        ev("cpu_op", "aten::item", 80, 20),
    ]
    s = trace.reduce(events, ["MessageLayerFunctionBackward"])
    assert abs(s["window_s"] - 100e-6) < 1e-12 and s["device_ops"] == 4
    assert abs(s["busy_s"] - 30e-6) < 1e-12  # 15-25, 45-50, 60-75
    assert abs(s["b1_s"] - 10e-6) < 1e-12 and abs(s["b2_s"] - 15e-6) < 1e-12
    assert s["breakdown"]["device_ops"][0][0] in ("b1_kernel", "b2_rows")
    gaps = dict(s["breakdown"]["idle_gaps"])
    assert abs(gaps["aten::item"] - 25e-6) < 1e-12  # 75-100 while the host waited


def test_no_window_or_no_device_work_reads_nothing():
    assert trace.reduce([ev("cpu_op", "x", 0, 1)]) is None
    assert trace.reduce([ev("user_annotation", trace.WINDOW, 0, 10)]) is None


def test_a_device_trace_alone_gives_busy_time_and_operations():
    events = [
        ev("kernel", "a", 10, 10, tid=7, corr=1),
        ev("kernel", "b", 15, 10, tid=8, corr=2),  # overlaps the first: counted once in busy time
        ev("gpu_memcpy", "copy", 40, 5, tid=7, corr=3),
        ev("cuda_runtime", "cudaLaunchKernel", 12, 1, corr=1),
    ]
    s = trace.device_summary(events, 100e-6)
    assert s["device_ops"] == 3 and abs(s["busy_s"] - 20e-6) < 1e-12 and s["window_s"] == 100e-6
    assert [k for k, _ in s["top"]] == ["a", "b", "copy"]
    assert trace.device_summary([ev("cuda_runtime", "cudaLaunchKernel", 12, 1)], 1.0) is None
