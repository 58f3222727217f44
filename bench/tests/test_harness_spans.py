"""The readers of the program's spans (``lib/spans.py`` and the metrics
that use it) on the smoke cells, on the CPU: with the program's spans each
reads a finite number (``h2d_gbps.score`` stays out: the CPU trace has no
copies), and a program without ``repro_torch.tracing`` gives none of them
and raises nothing.  The roots read are the window's only where their
``samples`` are the window's sizes, unit by unit."""

from __future__ import annotations

import sys
from types import SimpleNamespace

import pytest
import torch

import run
from harness_smoke import smoke
from lib import spans

READERS = {"dlrm-tb-robe.rank-2k-16k": ["copy_in_host_ms.rank",
                                        "model_host_ms.rank",
                                        "copy_out_host_ms.rank"],
           "dlrm-tb-robe.score-256k": ["copy_in_host_ms.score",
                                       "h2d_gbps.score"],
           "dlrm-tb-robe.train-64k": ["step_host_ms.train"]}


@pytest.mark.parametrize("spans", [True, False])
@pytest.mark.parametrize("name", sorted(READERS))
def test_span_readers(name, spans, monkeypatch):
    run._environment()
    if not spans:
        # what a program without spans gives: the readers' import fails
        # (the program's modules, loaded first, record as before)
        import repro_torch
        import repro_torch.serve.server  # noqa: F401
        import repro_torch.train.train_loop  # noqa: F401
        monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)
        monkeypatch.delattr(repro_torch, "tracing")
    cell = smoke(run.load_cell(name))
    assert set(READERS[name]) <= set(cell.wl["per_layer"])
    result = run.run_cell(cell, 2 ** 31 + 31, 0.2, True,
                          torch.device("cpu"))
    assert result["correct"] is True
    got = {k for k in result["metrics"] if k in READERS[name]}
    want = {k for k in READERS[name] if k != "h2d_gbps.score"}
    assert got == (want if spans else set())
    for k in got:
        m = result["metrics"][k]
        assert m["unit"] == "ms" and 0 < m["value"] < float("inf")


@pytest.mark.parametrize("sizes, found", [
    ([3, 5], True),            # the last two roots
    ([4, 3, 5], True),         # all three
    ([3, 6], False),           # a unit of another size
    ([2, 4, 3, 5], False),     # more units than roots
])
def test_window_spans_are_the_windows_own(sizes, found):
    from repro_torch import tracing
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]):
        for rows in (4, 3, 5):
            with tracing.span("server.score") as s:
                s.add("samples", rows)
                with tracing.span("server.copy_in"):
                    pass
    win = SimpleNamespace(units=list(range(len(sizes))), sizes=sizes)
    got = spans.window_spans(SimpleNamespace(win=win), "server.score")
    if not found:
        assert got is None
        return
    roots, kids = got
    assert [r.counts["samples"] for r in roots] == sizes
    assert all([k.name for k in kids[r.id]] == ["server.copy_in"]
               for r in roots)
