"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix; the harness finds ``configs`` entries' files, ``flowbench/traffic/<traffic>.json``,
``flowbench/checks/<cell>.json`` (the correctness comparison's sample and
limits) and one reader ``flowbench/metrics/<metric>.py`` for every metric
the cell reports.  Adding a cell, a mix, a configuration or a metric adds
files and entries; no file of the harness changes.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load_manifest() -> dict:
    path = ROOT / "BENCHMARK.json"
    if not path.exists():
        raise FileNotFoundError(f"{path} is missing")
    return json.loads(path.read_text())


def applies(metric: dict, cell: str) -> bool:
    """Whether ``metric`` is reported in ``cell``: listed there, or listed nowhere."""
    return "workloads" not in metric or cell in metric["workloads"]


def resolve_cell(manifest: dict, cell: str) -> dict:
    """Everything a run of ``cell`` needs: its entry, configuration, traffic, check and metrics."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if cell not in cells:
        raise KeyError(f"no workload {cell!r} in BENCHMARK.json")
    w = cells[cell]
    configs = {c["name"]: c for c in manifest["configs"]}
    cfg_entry = configs[w["config"]]
    config = json.loads((ROOT / cfg_entry["file"]).read_text())
    traffic = json.loads((BENCH_DIR / "traffic" / f"{w['traffic']}.json").read_text())
    check = json.loads((BENCH_DIR / "checks" / f"{cell}.json").read_text())
    return {
        "workload": w,
        "config": config,
        "traffic": traffic,
        "check": check,
        "end_to_end": [m for m in manifest["end_to_end"] if applies(m, cell)],
        "per_layer": [m for m in manifest["per_layer"] if applies(m, cell)],
    }


def reader(metric_name: str):
    """The ``read(ctx)`` function of ``flowbench/metrics/<metric_name>.py``."""
    path = BENCH_DIR / "metrics" / f"{metric_name}.py"
    spec = importlib.util.spec_from_file_location(f"flowbench_metric_{metric_name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
