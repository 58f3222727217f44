"""BENCHMARK.json against the benchmark's contract: its keys, names,
units, files and bounds, and the data files each cell is found by."""

from __future__ import annotations

import json
import re

import pytest

import run

BM = json.loads((run.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BM["workloads"]]


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level():
    assert set(BM) == {"command", "paths", "run_seconds", "configs",
                       "workloads", "end_to_end", "per_layer"}
    assert BM["command"] == ["python3", "bench/run.py"]
    assert BM["paths"] == ["bench"]
    assert isinstance(BM["run_seconds"], int) and 1 <= BM["run_seconds"] <= 51
    assert len((run.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    # a full check of 24 cells fits its 43,200 seconds
    n = 24
    assert (2 + 14 * n) * (BM["run_seconds"] + 60) + n * 180 + 1200 <= 43200


def test_configs():
    names = [c["name"] for c in BM["configs"]]
    assert len(set(names)) == len(names)
    used = {w["config"] for w in BM["workloads"]}
    for c in BM["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"])
        assert _line(c["why"])
        assert c["file"] == f"bench/configs/{c['name']}.json"
        assert json.loads((run.ROOT / c["file"]).read_text())["name"] == \
            c["name"]
        assert c["reduced"] == [] and c["name"] in used


def test_workloads():
    pairs = set()
    for w in BM["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and _line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert (run.BENCH / "traffic" / f"{w['traffic']}.json").exists()
    assert len(set(CELLS)) == len(CELLS)


@pytest.mark.parametrize("kind", ["end_to_end", "per_layer"])
def test_metrics(kind):
    e2e = {m["name"] for m in BM["end_to_end"]}
    for m in BM[kind]:
        keys = {"name", "unit", "better", "source"} | (
            {"bound"} if kind == "end_to_end" else {"layer", "moves"})
        assert keys <= set(m) <= keys | {"workloads"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
        if kind == "end_to_end":
            assert m["source"] in ("host_clock", "device_trace")
            assert 0.01 <= m["bound"] <= 0.25
        else:
            assert m["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")
            assert _line(m["layer"]) and m["moves"] in e2e
            moved = next(x for x in BM["end_to_end"] if x["name"] ==
                         m["moves"])
            assert set(m["workloads"]) <= set(moved.get("workloads", CELLS))
            assert (run.BENCH / "metrics" / f"{m['name']}.py").exists()
            if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
                assert m["unit"] == "%"


def test_every_cell_reports_enough():
    for cell in CELLS:
        e2e = [m["name"] for m in BM["end_to_end"]
               if cell in m.get("workloads", CELLS)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(cell in m["workloads"] for m in BM["per_layer"])
    setup = next(m for m in BM["end_to_end"] if m["name"] == "setup_s")
    assert "workloads" not in setup and setup["bound"] == 0.25


def test_one_layer_name_per_layer():
    """Metrics of one layer give it the same name, letter for letter."""
    layers = {m["layer"] for m in BM["per_layer"]}
    assert layers == {"server", "train loop", "model",
                      "embedding and kernels", "device", "whole step"}
