"""The port-span reduction on a hand-made trace: device time by launch, idle by midpoint, readback against
caller, the per-level join, the six readers, and the old readers unmoved by the port's spans."""
import pytest

from flowbench.lib import manifest, spans
from flowbench.lib.trace import analyse


def _x(cat, name, ts, dur, tid=1, corr=None):
    ev = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "pid": 1}
    if corr is not None:
        ev["args"] = {"correlation": corr}
    return ev


def _launch(ts, corr):
    return _x("cuda_runtime", "cudaLaunchKernel", ts, 2, corr=corr)


# two calls; the port's spans in the first, only its entry in the second; a child starts after its parent
PORT_SPANS = [
    ("entry", 30, 870), ("prepare", 31, 70), ("pyramid", 102, 98), ("stage", 200, 680),
    ("resample", 201, 49), ("level", 251, 619), ("warp", 260, 40), ("system", 300, 100),
    ("solve", 400, 300), ("entry", 1150, 100),
]
EVENTS = [_x("user_annotation", "oftpu." + n, s, d) for n, s, d in PORT_SPANS] + [
    _x("user_annotation", "flowbench.entry", 0, 1050),
    _x("user_annotation", "flowbench.entry", 1100, 200),
    _x("user_annotation", "flowbench.cg", 410, 280),
    _launch(32, 1), _launch(110, 2), _launch(210, 3), _launch(270, 4), _launch(290, 12), _launch(310, 5),
    _launch(320, 6), _launch(420, 7), _launch(750, 8), _launch(910, 9), _launch(1160, 10), _launch(1095, 11),
    _launch(1055, 13),
    _x("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 40, 40, tid=7, corr=1),
    _x("kernel", "resize", 150, 40, tid=7, corr=2),
    _x("kernel", "resample", 260, 10, tid=7, corr=3),
    _x("kernel", "interp", 280, 40, tid=7, corr=4),
    _x("gpu_memcpy", "Memcpy DtoD (Device -> Device)", 320, 10, tid=7, corr=12),
    _x("kernel", "stencil", 330, 50, tid=7, corr=5),
    _x("gpu_memset", "Memset (Device)", 385, 5, tid=7, corr=6),
    _x("kernel", "cg_resident", 430, 250, tid=7, corr=7),
    _x("kernel", "add", 760, 40, tid=7, corr=8),
    _x("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 950, 30, tid=7, corr=9),
    _x("kernel", "mul", 1170, 10, tid=7, corr=10),
    _x("kernel", "probe", 1100, 10, tid=7, corr=11),
    _x("kernel", "between", 1060, 10, tid=7, corr=13),
    _x("cpu_op", "aten::mul", 700, 50),
]
RECORDS = [{"name": n, "attrs": {"stage": 0, "level": 0, "H": 24, "W": 32, "B": 2} if n == "level" else {}}
           for n, _, _ in PORT_SPANS]


def test_device_time_goes_to_the_span_open_at_the_launch():
    s = spans.analyse(EVENTS, 2, RECORDS)
    assert s["warp_s"] == pytest.approx(50e-6)  # the kernel and the device-to-device copy
    assert s["system_s"] == pytest.approx(55e-6)  # the kernel and the memset
    assert s["pyramid_s"] == pytest.approx(50e-6)  # pyramid and resample; the upload is no plain op
    assert s["prepare_s"] == pytest.approx(70e-6)
    assert s["deep_share"] == pytest.approx(485 / 495)  # the second call's kernel sits under entry alone


def test_idle_gaps_go_to_the_span_at_their_midpoint():
    s = spans.analyse(EVENTS, 2, RECORDS)
    assert s["level_idle_s"] == pytest.approx(135e-6)
    assert s["nonlevel_idle_s"] == pytest.approx(590e-6)
    assert dict(s["idle_by_span"]) == pytest.approx({
        "caller": 100e-6, "pyramid": 70e-6, "resample": 70e-6, "warp": 10e-6, "system": 5e-6, "solve": 40e-6,
        "level": 80e-6, "stage": 150e-6, "readback": 80e-6, "between_calls": 30e-6, "entry": 120e-6})
    t = analyse(EVENTS, 2)
    idle = t["window_s"] - t["busy_s"]
    assert s["level_idle_s"] + s["nonlevel_idle_s"] + 30e-6 == pytest.approx(idle)
    assert s["warp_s"] + s["system_s"] + s["pyramid_s"] <= t["plain_s"]


def test_levels_join_records_by_order_or_not_at_all():
    s = spans.analyse(EVENTS, 2, RECORDS)
    assert s["levels"] == {(0, 0, 24, 32): pytest.approx([619e-6, 395e-6, 135e-6, 4])}
    lines = spans.level_table(s)
    assert len(lines) == 2 and "24x32" in lines[1] and lines[1].split()[-1] == "2.0"
    swapped = [dict(r) for r in RECORDS]
    swapped[1], swapped[2] = swapped[2], swapped[1]
    assert spans.analyse(EVENTS, 2, swapped)["levels"] is None
    assert spans.analyse(EVENTS, 2, RECORDS[:-1])["levels"] is None
    two_threads = [dict(e, tid=2) if e["name"] == "oftpu.warp" else e for e in EVENTS]
    assert spans.analyse(two_threads, 2, RECORDS)["levels"] is None
    assert spans.analyse(EVENTS, 2, None)["levels"] is None and spans.level_table(None) == []


NEW = {"prepare_ms_per_pair": 0.035, "level_idle_ms_per_pair": 0.0675, "nonlevel_idle_ms_per_pair": 0.295,
       "warp_device_ms": 0.025, "system_device_ms": 0.0275, "pyramid_device_ms": 0.025}


@pytest.mark.parametrize("name", sorted(NEW))
def test_span_readers(name):
    read = manifest.reader(name)
    assert read({"spans": spans.analyse(EVENTS, 2, RECORDS)}) == pytest.approx(NEW[name])
    assert read({}) is None
    assert read({"spans": spans.analyse([e for e in EVENTS if not e["name"].startswith("oftpu.")], 2)}) is None


@pytest.mark.parametrize("name", ["h2d_ms_per_pair", "launches_per_pair", "plain_ops_device_ms",
                                  "device_idle_share"])
def test_old_readers_unmoved_by_the_port_spans(name):
    without = [e for e in EVENTS if not e["name"].startswith("oftpu.")]
    a, b = analyse(EVENTS, 2), analyse(without, 2)
    read = manifest.reader(name)
    assert read({"trace": a}) == read({"trace": b})
    assert a["op_device_s"] == b["op_device_s"]
