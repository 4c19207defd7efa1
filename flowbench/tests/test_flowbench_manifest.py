"""BENCHMARK.json against the benchmark's contract, and every file it names found by name."""
import json
import re

import pytest

from flowbench.lib import manifest

M = manifest.load_manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT_KEYS = ("why", "layer", "source")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_sizes():
    assert set(M) == KEYS["top"]
    assert 1 <= len(M["paths"]) <= 16 and all(re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) for p in M["paths"])
    assert len(M["command"]) <= 32 and all(_line(w) for w in M["command"])
    assert isinstance(M["run_seconds"], int) and 1 <= M["run_seconds"] <= 51
    assert len(json.dumps(M).encode()) <= 64 * 1024


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_entries_have_just_their_keys_and_valid_names(section):
    names = [e["name"] for e in M[section]]
    assert len(names) == len(set(names))
    for e in M[section]:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") else set()
        assert KEYS[section] <= set(e) <= KEYS[section] | extra, e["name"]
        assert NAME.match(e["name"])
        for k in TEXT_KEYS:
            if k in e:
                assert _line(e[k]), (e["name"], k)
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")


def test_metrics_are_unique_across_sections_and_bounds_in_range():
    names = [m["name"] for m in M["end_to_end"] + M["per_layer"]]
    assert len(names) == len(set(names))
    assert any(m["name"] == "setup_s" for m in M["end_to_end"])
    for m in M["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in M["end_to_end"]}
    for m in M["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e


@pytest.mark.parametrize("cell", [w["name"] for w in M["workloads"]])
def test_every_cell_resolves_by_name(cell):
    spec = manifest.resolve_cell(M, cell)
    w = spec["workload"]
    assert w["chips"] in (1, 4) and NAME.match(w["config"]) and NAME.match(w["traffic"])
    assert spec["config"]["name"] == w["config"] and spec["traffic"]["name"] == w["traffic"]
    reported = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in reported and len(reported) >= 2 and spec["per_layer"]
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert callable(manifest.reader(m["name"]))
    for m in spec["per_layer"]:
        assert m["moves"] in reported
    for spec_n in spec["check"]["numbers"].values():
        assert spec_n["limit"] > 0
    assert (manifest.BENCH_DIR / "pools" / f"{spec['traffic']['pool']}.json").exists()


def test_configs_are_used_and_their_files_lie_under_paths():
    used = {w["config"] for w in M["workloads"]}
    files = [c["file"] for c in M["configs"]]
    assert len(files) == len(set(files))
    for c in M["configs"]:
        assert c["name"] in used
        assert any(c["file"].startswith(p + "/") for p in M["paths"])
        assert json.loads((manifest.ROOT / c["file"]).read_text())["reduced"] == c["reduced"] == []
    assert len({(w["config"], w["traffic"]) for w in M["workloads"]}) == len(M["workloads"])
