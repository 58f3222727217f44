"""Each cell of BENCHMARK.json end to end at smoke size on the CPU (the
program's plain versions), through the benchmark's own run and report:
the last line meets the result contract, every metric the cell lists is
there with its unit, and the output check passes."""

from __future__ import annotations

import json

import pytest
import torch

import run
from harness_smoke import smoke

BM = json.loads((run.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BM["workloads"]]
UNITS = {m["name"]: m["unit"] for m in BM["end_to_end"] + BM["per_layer"]}


def _listed(kind: str, cell: str) -> set:
    return {m["name"] for m in BM[kind]
            if cell in m.get("workloads", CELLS)}


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_and_reports(name, trace, capsys):
    run._environment()
    cell = smoke(run.load_cell(name))
    result = run.run_cell(cell, 2 ** 31 + 977, 0.2, bool(trace),
                          torch.device("cpu"))
    run.report(result)
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    for key in ("correct", "attempted", "failed", "metrics", "device"):
        assert key in line
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert err.strip().splitlines()[-len(line["checks"]):] == [
        f"check {k} {c['value']!r} limit {c['limit']!r}"
        for k, c in line["checks"].items()]
    if trace:
        # the CPU has no device events: the readers of kernels find
        # nothing and stay out of the line; the rest are there
        assert set(line["metrics"]) <= _listed("per_layer", name)
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(line["metrics"]) == _listed("end_to_end", name)
    for k, m in line["metrics"].items():
        assert m["unit"] == UNITS[k] and m["value"] == m["value"]


def test_workload_files_match_benchmark_json():
    for w in BM["workloads"]:
        cell = run.load_cell(w["name"])
        assert cell.wl["config"] == w["config"]
        assert cell.wl["traffic"] == w["traffic"]
        assert cell.wl["chips"] == w["chips"]
        assert set(cell.wl["end_to_end"]) | {"setup_s"} == \
            _listed("end_to_end", w["name"])
        assert set(cell.wl["per_layer"]) == _listed("per_layer", w["name"])
        for m in cell.wl["per_layer"]:
            assert run._metric(m).UNIT == UNITS[m]
