"""The reading of a device trace: busy time, time per operation and per
span (through the launch's correlation id), idle gaps by the host's span."""
import pytest

from spgemm_bench import trace


def _x(cat, name, ts, dur, pid=1, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": pid, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_summarize_attributes_device_time_to_the_launching_span():
    events = [
        _x("user_annotation", "bench.exec", 0, 100),
        _x("user_annotation", "bench.unpack", 100, 50),
        _x("user_annotation", "bench.inner", 10, 20),  # nested in exec
        _x("cuda_runtime", "cudaLaunchKernel", 5, 1, corr=1),
        _x("cuda_runtime", "cudaLaunchKernel", 15, 1, corr=2),
        _x("cuda_runtime", "cudaMemsetAsync", 120, 1, corr=3),
        _x("cuda_runtime", "cudaLaunchKernel", 200, 1, corr=4),
        _x("kernel", "scalar_runs<float>", 20, 10, pid=0, tid=7, corr=1),
        _x("kernel", "fill", 25, 10, pid=0, tid=7, corr=2),  # overlaps the first
        _x("gpu_memset", "Memset", 130, 20, pid=0, tid=7, corr=3),
        _x("kernel", "fill", 210, 5, pid=0, tid=7, corr=4),
        _x("cpu_op", "aten::index", 0, 1),
    ]
    s = trace.summarize({"traceEvents": events}, 1e-3)
    assert s["busy_s"] == pytest.approx((15 + 20 + 5) * 1e-6)
    assert s["by_op"] == pytest.approx({"scalar_runs<float>": 10e-6, "fill": 15e-6,
                                        "Memset": 20e-6})
    assert s["by_range"] == pytest.approx({"bench.exec": 10e-6, "bench.inner": 10e-6,
                                           "bench.unpack": 20e-6, "outside spans": 5e-6})
    # gaps: 35..130 starts inside exec (host at 35: exec), 150..210 in unpack's end
    assert s["idle_by_span"] == pytest.approx({"bench.exec": 95e-6, "bench.unpack": 60e-6})
    assert [name for name, _ in trace.top(s["by_op"], 2)] == ["Memset", "fill"]
