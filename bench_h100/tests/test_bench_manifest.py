"""BENCHMARK.json against the benchmark's contract, and every piece a cell
names found by its name."""
from __future__ import annotations

import importlib
import json
import re

import pytest
from conftest import BENCH, ROOT

from harness.common import Manifest, load_reader

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
CELL_KEYS = {"name", "config", "traffic", "chips", "why"}
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())


def one_line(text) -> bool:
    return isinstance(text, str) and 1 <= len(text) <= 200 and not re.search(r"[\n\r\t]", text)


def test_top_level_and_sizes():
    assert set(MANIFEST) == KEYS
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(MANIFEST["paths"]) <= 16
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
               for p in MANIFEST["paths"])
    assert 1 <= len(MANIFEST["command"]) <= 32 and all(map(one_line, MANIFEST["command"]))
    assert 1 <= MANIFEST["run_seconds"] <= 51 and isinstance(MANIFEST["run_seconds"], int)
    # a full check of 24 cells: 2 + 14 x 24 runs, 2 x 90 s to compile a cell, 1200 s spare
    assert (2 + 14 * 24) * (MANIFEST["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len(MANIFEST["workloads"]) <= 24


@pytest.mark.parametrize("entry", MANIFEST["configs"], ids=lambda e: e["name"])
def test_config_entries(entry):
    assert set(entry) == CONFIG_KEYS
    assert NAME.match(entry["name"]) and one_line(entry["why"]) and one_line(entry["source"])
    assert entry["file"].startswith(tuple(p + "/" for p in MANIFEST["paths"]))
    assert all(NAME.match(k) for k in entry["reduced"]) and len(entry["reduced"]) <= 16
    cfg = json.loads((ROOT / entry["file"]).read_text())
    assert cfg["name"] == entry["name"] and cfg["source"] == entry["source"]
    assert any(c["config"] == entry["name"] for c in MANIFEST["workloads"])


@pytest.mark.parametrize("cell", MANIFEST["workloads"], ids=lambda c: c["name"])
def test_cells_found_by_name(cell):
    assert set(cell) == CELL_KEYS
    assert all(NAME.match(cell[k]) for k in ("name", "config", "traffic"))
    assert cell["chips"] in (1, 4) and one_line(cell["why"])
    manifest = Manifest()
    traffic = manifest.traffic(cell["traffic"])
    assert importlib.import_module(f"harness.{traffic['kind']}").run
    assert manifest.config(cell["config"])["model"]
    limits = manifest.limits(cell["name"])
    assert limits and all(v > 0 for v in limits.values())
    e2e = [m["name"] for m in manifest.end_to_end(cell["name"])]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert manifest.per_layer(cell["name"])


def test_names_are_unique():
    for group in ("configs", "workloads"):
        names = [e["name"] for e in MANIFEST[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]]
    assert len(metrics) == len(set(metrics))
    pairs = [(c["config"], c["traffic"]) for c in MANIFEST["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("metric", MANIFEST["end_to_end"], ids=lambda m: m["name"])
def test_end_to_end_metrics(metric):
    assert set(metric) - {"workloads"} == E2E_KEYS
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher") and metric["source"] in ("host_clock",
                                                                            "device_trace")
    assert 0.01 <= metric["bound"] <= 0.25


@pytest.mark.parametrize("metric", MANIFEST["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metrics_and_readers(metric):
    assert set(metric) - {"workloads"} == LAYER_KEYS
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher") and metric["source"] in SOURCES
    assert one_line(metric["layer"])
    moves = next(m for m in MANIFEST["end_to_end"] if m["name"] == metric["moves"])
    assert set(metric["workloads"]) <= set(moves["workloads"])
    assert callable(load_reader(metric["name"]))
    assert (BENCH / "metrics" / f"{metric['name']}.py").exists()

