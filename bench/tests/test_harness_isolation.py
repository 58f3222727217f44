"""What the benchmark's process may load: no module whose top-level name
is ``jax``, ``jaxlib``, ``flax`` or ``repro`` (whole names: ``repro_torch``
is the program), and nothing of the program in ``bench/reference/``."""

from __future__ import annotations

import ast
import os
import subprocess
import sys
import textwrap

import run

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path) -> set:
    tree = ast.parse(open(path).read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_forbidden_names_compare_whole(monkeypatch):
    assert run.FORBIDDEN == ("jax", "jaxlib", "flax", "repro")
    # a test process may have loaded them already (the JAX package's tests)
    for name in [m for m in sys.modules if m.split(".")[0] in FORBIDDEN]:
        monkeypatch.delitem(sys.modules, name)
    before = dict(sys.modules)
    try:
        sys.modules["repro_torch_x"] = sys.modules["run"]
        assert "repro" not in run.forbidden_modules()
        sys.modules["repro.kernels"] = sys.modules["run"]
        assert run.forbidden_modules() == ["repro"]
    finally:
        for k in set(sys.modules) - set(before):
            del sys.modules[k]


def test_a_run_loads_no_jax_nor_repro():
    """A whole smoke run of every cell, traced too, in a fresh process."""
    code = textwrap.dedent(f"""
        import sys
        sys.path[:0] = [{str(run.BENCH)!r}, {str(run.BENCH / 'tests')!r}]
        import run
        run._environment()
        import torch
        from harness_smoke import smoke
        import json
        bm = json.loads((run.ROOT / "BENCHMARK.json").read_text())
        for w in bm["workloads"]:
            for tr in (False, True):
                r = run.run_cell(smoke(run.load_cell(w["name"])), 3, 0.1,
                                 tr, torch.device("cpu"))
                assert r["correct"], r
        print(sorted({{m.split(".")[0] for m in sys.modules}}))
    """)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in loaded
    assert not loaded & FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    ref_dir = run.BENCH / "reference"
    for f in sorted(ref_dir.glob("*.py")):
        names = _imports(f)
        assert not names & (FORBIDDEN | {"repro_torch"}), (f.name, names)
    code = textwrap.dedent(f"""
        import sys
        sys.path[:0] = [{str(run.BENCH)!r}]
        import reference.models, reference.robe_hash
        print(sorted({{m.split(".")[0] for m in sys.modules}}))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert not loaded & (FORBIDDEN | {"repro_torch"})


def test_no_card_no_result():
    """Without a card the command exits non-zero and prints no result."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, str(run.BENCH / "run.py"),
                          "--workload", "dlrm-tb-robe.score-256k", "--seed",
                          "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
