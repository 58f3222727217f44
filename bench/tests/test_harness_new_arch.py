"""A new architecture enters the benchmark as new files only.

The test copies ``bench/`` and adds a toy architecture of its own, file by
file: its arch module and plain reference, a configuration, a traffic
file and its driver, an entry, a workload file and two per-layer readers.
Its units hold ``tokens`` [B, T] int32 and no ``sparse``, it has no ROBE
array, and its ``mfu`` divides by the bf16 rate.  In a fresh process the
copy's ``run.run_cell`` then runs the toy cell on the CPU, untraced and
traced, and with the faults ``half_batch`` and ``alter``; and
``run.per_layer`` reads a trace in which every kernel matches.  No file
that was in the copy before changes."""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import sys
import textwrap

import run

TOY = {
    "archs/toylm.py": '''
        """A bag of token embeddings and a linear head."""
        REFERENCE = "toylm"


        def make_params(cfg, seed, device):
            import torch
            gen = torch.Generator(device=device)
            gen.manual_seed(seed % 2 ** 63)
            v, d = cfg["vocab"], cfg["dim"]
            z = torch.randn(v * d + d, generator=gen, device=device)
            return {"embed": z[:v * d].view(v, d), "head": z[v * d:]}


        def model_flops(cfg):
            return {"score": 2 * cfg["seq"] * cfg["dim"]}


        def touched(cfg, unit, device):
            return None
        ''',
    "reference/toylm.py": '''
        import torch


        def scores(params, cfg, batch, device):
            t = torch.as_tensor(batch["tokens"]).to(device).long()
            with torch.no_grad():
                return (params["embed"][t].mean(dim=1)
                        @ params["head"]).cpu().numpy()
        ''',
    "configs/toy-lm.json": json.dumps(
        {"name": "toy-lm", "arch": "toylm", "vocab": 1000, "dim": 16,
         "seq": 8, "compute_dtype": "bfloat16"}),
    "traffic/toy-tokens.json": json.dumps(
        {"driver": "toy_tokens", "batch": 64, "pool": 2, "check_units": 2,
         "trace_seconds": 0.2}),
    "traffic/toy_tokens.py": '''
        import time

        import numpy as np

        from lib.window import Window, pick, warm


        def inputs(cfg, traffic, seed):
            rs = np.random.RandomState(seed % 2 ** 31)
            shape = (traffic["batch"], cfg["seq"])
            return [{"tokens": rs.randint(0, cfg["vocab"], shape)
                     .astype(np.int32)} for _ in range(traffic["pool"])]


        prepare = warm


        def window(entry, pool, seconds, span, prep):
            units, sizes, outs = [], [], []
            t0 = time.perf_counter()
            with span("bench.window"):
                while True:
                    i = len(units) % len(pool)
                    with span("bench.unit"):
                        outs.append(entry.score(pool[i]))
                    units.append(i)
                    sizes.append(pool[i]["tokens"].shape[0])
                    t = time.perf_counter()
                    if t - t0 >= seconds:
                        break
            return Window(units=units, sizes=sizes, elapsed=t - t0,
                          outputs=outs)


        def end_to_end(win):
            return {"seqs_per_s": (win.samples / win.elapsed, "seqs/s")}


        def checks(win, pool, traffic, seed, prep, reference):
            n, gap = len(win.units), 0.0
            for j in pick(n, traffic["check_units"], seed, always=(n - 1,)):
                want, got = reference.scores(pool[win.units[j]]), win.outputs[j]
                gap = max(gap, float(np.max(np.abs(got - want)))
                          if got.shape == want.shape else float("inf"))
            return {"score_gap": gap, "failed": 0}
        ''',
    "entries/toylm_scores.py": '''
        import torch


        class Entry:
            def __init__(self, cfg, params, device, options):
                self.params, self.device = params, device

            def score(self, batch):
                t = torch.as_tensor(batch["tokens"]).to(self.device).long()
                emb = torch.nn.functional.embedding(t, self.params["embed"])
                return (emb.mean(dim=1) @ self.params["head"]).numpy()
        ''',
    "workloads/toy-lm.tokens.json": json.dumps(
        {"config": "toy-lm", "traffic": "toy-tokens", "chips": 1,
         "entry": "toylm_scores", "entry_options": {},
         "end_to_end": ["seqs_per_s"], "per_layer": ["mfu.tokens"],
         "checks": {"score_gap": 1e-5, "failed": 0}}),
    "metrics/mfu.tokens.py": '''
        """mfu.tokens: the toy's FLOPs over the window, per cent of bf16."""
        UNIT = "%"


        def read(ctx):
            return (100.0 * ctx.flops["score"] * ctx.win.samples
                    / ctx.trace.window_s / ctx.rates[2])
        ''',
    "metrics/lookup_roofline.tokens.py": '''
        """lookup_roofline.tokens: a ROBE roofline, which the toy cannot
        have."""
        from lib.readers import roofline
        from lib.work import robe_lookup

        UNIT = "%"


        def work(ctx, i):
            b, t = ctx.pool[i]["tokens"].shape
            return robe_lookup(b, t, ctx.cfg["dim"], ctx.touched(i))


        def read(ctx):
            return roofline(ctx, ("embedding",), work)
        ''',
}

SCRIPT = '''
import json
import sys
sys.path.insert(0, {bench!r})
import run
run._environment()
import torch
from lib.window import Window

cpu = torch.device("cpu")
cell = run.load_cell("toy-lm.tokens")
out = {{}}
for trace in (0, 1):
    out["trace%d" % trace] = run.run_cell(cell, 2 ** 31 + 3, 0.2, bool(trace),
                                          cpu)
for fault in ("half_batch", "alter"):
    out[fault] = run.run_cell(cell, 2 ** 31 + 3, 0.2, False, cpu,
                              fault=fault)


class EveryKernel:
    window_s = busy_s = 1.0

    def seconds(self, match):
        return 1.0

    def count(self, match):
        return 1


cell.wl["per_layer"] = ["mfu.tokens", "lookup_roofline.tokens"]
pool = run.importlib.import_module("traffic.toy_tokens").inputs(
    cell.cfg, cell.traffic, 5)
win = Window(units=[0, 1], sizes=[64, 64], elapsed=1.0)
out["read"] = run.per_layer(cell, win, EveryKernel(), pool, cpu, "H100")
print(json.dumps(out))
'''


def _hashes(root) -> dict:
    out = {}
    for dirpath, dirnames, files in os.walk(root):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for f in files:
            p = os.path.join(dirpath, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def test_a_new_architecture_is_new_files_only(tmp_path):
    bench = tmp_path / "bench"
    shutil.copytree(run.BENCH, bench, ignore=shutil.ignore_patterns(
        "__pycache__", "*.pyc"))
    before = _hashes(bench)
    for rel, text in TOY.items():
        assert rel not in before, rel
        (bench / rel).write_text(textwrap.dedent(text).lstrip())
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    done = subprocess.run(
        [sys.executable, "-c", SCRIPT.format(bench=str(bench))],
        capture_output=True, text=True, env=env, timeout=600,
        cwd=tmp_path)
    assert done.returncode == 0, done.stderr[-3000:]
    out = json.loads(done.stdout.strip().splitlines()[-1])

    for trace in ("trace0", "trace1"):
        assert out[trace]["correct"] is True, out[trace]["checks"]
    assert set(out["trace0"]["metrics"]) == {"setup_s", "seqs_per_s"}
    mfu = out["trace1"]["metrics"]["mfu.tokens"]
    assert mfu["unit"] == "%" and 0 < mfu["value"] < 100
    for fault in ("half_batch", "alter"):
        assert out[fault]["correct"] is False, out[fault]["checks"]
    # 2 x 8 x 16 FLOPs a sequence, 128 sequences in one second, at 989 TFLOP/s
    assert out["read"] == {"mfu.tokens": {
        "value": 100.0 * 2 * 8 * 16 * 128 / 989e12, "unit": "%"}}

    after = _hashes(bench)
    assert {k: after[k] for k in before} == before
