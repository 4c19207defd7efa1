"""The port's spans (``utils/profiling.py::annotate``) from the entry call down to the kernel calls.

Under ``utils.profiling.trace`` a Classic+NL call through ``estimate_flow``
and a Classic++ batch through ``estimate_flow_batched_rgb`` emit one
``entry`` a call and under it the tree of the pipeline's layers: the
upload, the texture, the pyramids, each GNC stage's resample and level
spans, and inside each level its warps, IRLS systems, solves and filters,
as many as the plan asks for.  The k-th record is the trace's k-th
``oftpu.*`` event, and the tree is the events' nesting.  With no profiler
recording a span is the shared null context, no record is made, and the
flows are bit-identical to a traced call's; each trace starts its records
anew.
"""
import json
from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_parity import one_cpu_thread  # noqa: E402,F401

from optical_flow_tpu_torch import estimate_flow, load_of_method  # noqa: E402
from optical_flow_tpu_torch.parallel.batch import estimate_flow_batched_rgb  # noqa: E402
from optical_flow_tpu_torch.utils import profiling  # noqa: E402

PARAMS = {"display": False, "max_iters": 2}


def _frames(B=None):
    rng = np.random.default_rng(7)
    a = rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)
    b = np.roll(a, 1, axis=1)
    if B is None:
        return a, b
    return np.stack([a, np.flip(a, 0)][:B]), np.stack([b, np.flip(b, 0)][:B])


def _single(method):
    a, b = _frames()
    return estimate_flow(a, b, method, PARAMS, device="cpu"), 1


def _batched(method):
    a, b = _frames(2)
    return estimate_flow_batched_rgb(a, b, method, params=PARAMS, device="cpu"), 2


CASES = {"classic+nl-fast": (_single, "nonlocal"), "classic++": (_batched, "median")}


def _plan(method):
    ope = load_of_method(method)
    ope.parse_input_parameter(PARAMS)
    if method == "classic+nl-fast":
        plan = ope._make_nl_plan((48, 64), use_color=True)
        return plan, [(cfg.irls, a) for cfg, a in plan.stages]
    plan = ope._make_plan((48, 64))
    return plan, list(plan.stages)


def _parents(logdir, records):
    """The index of each span's parent in start order, from the nesting of the trace's ``oftpu.*`` events,
    after checking that the k-th record is the k-th event."""
    events = [e for e in json.loads((logdir / "trace.json").read_text())["traceEvents"]
              if e.get("ph") == "X" and e.get("name", "").startswith(profiling.SPAN_PREFIX)]
    events.sort(key=lambda e: (float(e["ts"]), -float(e.get("dur", 0))))
    assert [e["name"] for e in events] == [profiling.SPAN_PREFIX + r["name"] for r in records]
    assert len({e["tid"] for e in events}) == 1
    parents, open_ = [], []
    for k, e in enumerate(events):
        while open_ and float(events[open_[-1]]["ts"]) + float(events[open_[-1]]["dur"]) <= float(e["ts"]):
            open_.pop()
        parents.append(open_[-1] if open_ else None)
        open_.append(k)
    return parents


def _children(parents, i):
    return [k for k, p in enumerate(parents) if p == i]


@pytest.mark.parametrize("method", sorted(CASES))
def test_a_traced_call_emits_the_span_tree_of_its_plan(method, tmp_path):
    run, filt = CASES[method]
    untraced, B = run(method)
    profiling.clear_span_records()
    assert profiling.span_records() == []
    with profiling.trace(str(tmp_path)):
        traced, _ = run(method)
    records = profiling.span_records()
    profiling.clear_span_records()
    assert torch.equal(untraced, traced)
    parents = _parents(tmp_path, records)

    assert _children(parents, None) == [0] and records[0]["name"] == "entry"
    assert records[0]["attrs"] == {"B": B, "H": 48, "W": 64, "method": method}
    top = [records[k]["name"] for k in _children(parents, 0)]
    n_stages = top.count("stage")
    assert top == ["prepare"] * (2 if B > 1 else 1) + ["preprocess", "pyramid"] + \
        (["pyramid"] if method == "classic+nl-fast" else []) + ["stage"] * n_stages
    assert records[1]["attrs"] == {"bytes": 2 * B * 48 * 64 * 3}  # the uint8 frames

    plan, stages = _plan(method)
    assert n_stages == len(stages) >= 2
    for s, k in enumerate(_children(parents, 0)[-n_stages:]):
        cfg, alpha = stages[s]
        assert records[k]["attrs"] == {"stage": s, "alpha": alpha}
        levels = plan.levels if s == 0 else plan.gnc_levels
        shapes = plan.shapes if s == 0 else plan.gnc_shapes
        kids = _children(parents, k)
        assert [records[c]["name"] for c in kids] == ["resample", "level"] * levels
        for i, lvl in enumerate(range(levels - 1, -1, -1)):
            H, W = shapes[lvl]
            assert records[kids[2 * i]]["attrs"] == {"H": H, "W": W}
            level = kids[2 * i + 1]
            assert records[level]["attrs"] == {"stage": s, "level": lvl, "H": H, "W": W, "B": B}
            inner = Counter(records[c]["name"] for c in _children(parents, level))
            solves = cfg.max_iters * cfg.max_linear
            want = {"warp": cfg.max_iters + 1, "system": solves, "solve": solves, filt: solves}
            if method == "classic+nl-fast":
                want["occlusion"] = solves
            assert inner == want
            assert all(not _children(parents, c) for c in _children(parents, level))


def test_without_a_profiler_a_span_is_the_shared_null_context():
    profiling.clear_span_records()
    assert profiling.annotate("level", stage=0) is profiling.annotate("warp")
    with profiling.annotate("entry", B=1):
        with profiling.annotate("solve"):
            pass
    assert profiling.span_records() == []


def test_each_trace_starts_its_records_anew(tmp_path):
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("entry", B=2):
            with profiling.annotate("prepare", bytes=6):
                pass
    first = profiling.span_records()
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("entry", B=1):
            pass
    assert first == [{"name": "entry", "attrs": {"B": 2}}, {"name": "prepare", "attrs": {"bytes": 6}}]
    assert profiling.span_records() == [{"name": "entry", "attrs": {"B": 1}}]
    profiling.clear_span_records()
    assert profiling.span_records() == []


def test_the_chain_spans_say_how_their_chain_ran(tmp_path):
    """``warp``, ``system``, ``occlusion`` and ``guard`` carry the attribute
    ``graph`` (``utils/graphs.py``): on the CPU every chain runs eagerly."""
    a, b = _frames()
    with profiling.trace(str(tmp_path)):
        estimate_flow(a, b, "classic+nl-fast", {**PARAMS, "guard_flow": 1e9}, device="cpu")
    records = profiling.span_records()
    profiling.clear_span_records()
    chains = [r for r in records if "graph" in r["attrs"]]
    assert {r["name"] for r in chains} == {"warp", "system", "occlusion", "guard"}
    assert all(r["attrs"] == {"graph": "eager"} for r in chains)
    assert {r["name"] for r in records} - {r["name"] for r in chains} == {
        "entry", "prepare", "preprocess", "pyramid", "stage", "resample", "level", "solve", "nonlocal"}
