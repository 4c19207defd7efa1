"""The trace reduction on a hand-made trace: attribution by correlation and range, busy union, idle gaps."""
import pytest

from flowbench.lib.trace import analyse


def _x(cat, name, ts, dur, tid=1, corr=None):
    ev = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "pid": 1}
    if corr is not None:
        ev["args"] = {"correlation": corr}
    return ev


EVENTS = [
    _x("user_annotation", "flowbench.entry", 0, 1000),
    _x("user_annotation", "flowbench.cg", 100, 200),
    _x("user_annotation", "flowbench.wmedian", 400, 100),
    _x("cuda_runtime", "cudaMemcpyAsync", 50, 5, corr=4),
    _x("cuda_runtime", "cudaLaunchKernel", 150, 5, corr=1),
    _x("cuda_runtime", "cudaLaunchKernel", 450, 5, corr=2),
    _x("cuda_runtime", "cudaLaunchKernel", 600, 5, corr=3),
    _x("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 60, 20, tid=7, corr=4),
    _x("kernel", "cg_resident", 200, 200, tid=7, corr=1),
    _x("kernel", "wmedian_kernel", 450, 100, tid=7, corr=2),
    _x("kernel", "elementwise", 700, 50, tid=7, corr=3),
    _x("cpu_op", "aten::mul", 600, 50),
    _x("cpu_op", "aten::add", 800, 100),
]


def test_analyse_attributes_by_range_not_by_name():
    a = analyse(EVENTS, n_pairs=2)
    assert a["window_s"] == pytest.approx(1000e-6)
    assert a["busy_s"] == pytest.approx(370e-6)
    assert a["kernels"] == 3 and a["h2d_copies"] == 1 and a["h2d_s"] == pytest.approx(20e-6)
    assert a["plain_s"] == pytest.approx(50e-6)
    assert a["op_device_s"] == pytest.approx({"cg": 200e-6, "wmedian": 100e-6})
    gaps = dict(a["idle_gaps"])
    assert gaps == pytest.approx({"entry/python": 60e-6, "cg/python": 120e-6, "wmedian/python": 50e-6,
                                  "entry/aten::mul": 150e-6, "entry/aten::add": 250e-6})
    assert a["device_ops"][0] == ["cg_resident", pytest.approx(200e-6)]


def test_no_entry_range_reads_nothing():
    assert analyse([e for e in EVENTS if e["name"] != "flowbench.entry"], 1) is None
