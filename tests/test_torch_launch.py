"""The port's launch tooling against the JAX package's, on the CPU.

* ``launch.cells``: every default cell on both production meshes, built by
  the JAX package on 512 forced host devices and by the port on a fake
  world of 256 / 512 ranks, has the same id, skip, note, model FLOPs
  (rel 1e-12), input shapes and dtypes and input sharding specs;
* ``launch.dryrun``: the wire-byte factors, the collective log's counts
  and bytes on a known sequence of calls, the registry's 40 assigned
  cells, and ``run_cell`` on six cells of the ``single`` mesh (the
  ``robe``, ``hashed`` and ``tt`` serve records with no collective, as
  the JAX package's committed records have none);
* ``launch.roofline``: ``run_probe``'s extrapolation equals the full
  count, ``corrected_terms`` and ``LEVERS`` on a synthetic record with
  the H100's constants; ``launch.report``'s tables from synthetic
  records;
* the repairs the dry run needed: the MoE's static-shape expert count,
  the backends' ``local_batch`` and ``make_mesh`` on a fake world.

A process holds one world, so every fake world runs in a subprocess of
its own (no xdist worker is left with a default process group); the five
subprocesses run side by side, once a module.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")

# -- the subprocesses ------------------------------------------------------

_JAX_DUMP = """
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import jax
from jax.sharding import NamedSharding
from repro.dist import api as dist
from repro.launch.cells import build_cell
from repro.launch.dryrun import default_cells
from repro.launch.mesh import make_context

def norm(spec):
    out = [e if e is None or isinstance(e, str) else
           (e[0] if len(e) == 1 else list(e)) for e in spec]
    while out and out[-1] is None:
        out.pop()
    return out

multi = sys.argv[1] == "multi"
ctx = make_context(multi_pod=multi)
out = {}
with dist.use(ctx):
    for arch, shape, emb in default_cells():
        cell = build_cell(arch, shape, ctx, emb)
        leaves = []
        if not cell.skip:
            a = jax.tree.leaves(cell.arg_shapes)
            s = jax.tree.leaves(cell.in_shardings,
                                is_leaf=lambda x: isinstance(x,
                                                             NamedSharding))
            assert len(a) == len(s), cell.cell_id
            leaves = [[list(x.shape), str(x.dtype), norm(sh.spec)]
                      for x, sh in zip(a, s)]
        out["/".join((arch, shape, emb))] = dict(
            cell_id=cell.cell_id, skip=cell.skip, note=cell.note,
            flops=cell.model_flops_per_step, leaves=leaves)
json.dump(out, open(sys.argv[2], "w"))
"""

_PORT_DUMP = """
import sys, json
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from repro_torch.dist import api as dist
from repro_torch.launch import cells, dryrun
from repro_torch.launch.mesh import make_context

from repro_torch.tree import leaves, tree_map

def norm(spec):
    out = [e if e is None or isinstance(e, str) else list(e) for e in spec]
    while out and out[-1] is None:
        out.pop()
    return out

def arg_leaves(cell):
    # [shape, dtype, spec] of every tensor input, in jax.tree order (None
    # leaves skipped, as jax.tree skips an empty subtree)
    out = []
    for a, s in zip(cell.arg_shapes, cell.in_shardings):
        flat_s = leaves(tree_map(lambda x, sh: sh, a, s))
        for x, sh in zip(leaves(a), flat_s):
            if x is not None:
                out.append([list(x.shape),
                            str(x.dtype).replace("torch.", ""),
                            norm(() if sh is None else sh.spec)])
    return out

multi = sys.argv[1] == "multi"
dryrun.fake_world(512 if multi else 256)
ctx = make_context(multi_pod=multi, device="cpu")
out = {"__mesh__": [dict(ctx.mesh.shape), list(ctx.mesh.axis_names),
                    ctx.mesh.coords, str(ctx.device)]}
with FakeTensorMode(), dist.use(ctx):
    for arch, shape, emb in dryrun.default_cells():
        cell = cells.build_cell(arch, shape, ctx, emb)
        out["/".join((arch, shape, emb))] = dict(
            cell_id=cell.cell_id, skip=cell.skip, note=cell.note,
            flops=cell.model_flops_per_step,
            leaves=[] if cell.skip else arg_leaves(cell))
json.dump(out, open(sys.argv[2], "w"))
"""

# one fake world of 256 ranks: the collective log, run_cell, run_probe
_SINGLE_WORLD = """
import json, sys
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from repro_torch.dist import api as dist
from repro_torch.dist import collectives as coll
from repro_torch.launch import dryrun, roofline
from repro_torch.launch.mesh import make_context

out_dir = sys.argv[2]
dryrun.RESULTS_DIR = roofline.RESULTS_DIR = out_dir
dryrun.fake_world(256)
ctx = make_context(device="cpu")
res = {}

# a known sequence of calls on the 16x16 mesh
coll.counts.clear(); coll.nbytes.clear()
with FakeTensorMode():
    x = torch.empty(64, 128)                                # 32 KiB f32
    coll.all_gather(x, ctx, "data", 0)                      # 16 x 32 KiB
    coll.all_gather(x.to(torch.bfloat16), ctx, ("data", "model"), 1)
    coll.reduce_scatter(torch.empty(256, 8), ctx, "model", 0)
    coll.all_to_all(torch.empty(32, 4, dtype=torch.int32), ctx, "model")
    coll.all_reduce(x, ctx, ("data", "model"))
    coll.all_reduce_(torch.empty(3), ctx, "data", "max")
res["log"] = dryrun.collective_log()

cases = [("dlrm-rm2", "serve_p99", e) for e in
         ("default", "full", "hashed", "tt")] + [
        ("qwen3-0.6b", "decode_32k", "default"),
        ("gatedgcn", "molecule", "default")]
res["records"] = {"/".join(c): dryrun.run_cell(*c[:2], False, c[2],
                                               force=True)
                  for c in cases}
res["probes"] = [roofline.run_probe("qwen3-0.6b", "decode_32k", k,
                                    force=True) for k in (2, 3)]
json.dump(res, open(out_dir + "/result.json", "w"))
"""


def _run(code: str, *args):
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    return subprocess.Popen([sys.executable, "-c", textwrap.dedent(code)]
                            + list(args), env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    d = tmp_path_factory.mktemp("launch")
    procs = {}
    for mesh in ("single", "multi"):
        procs[f"jax-{mesh}"] = _run(_JAX_DUMP, mesh, str(d / f"j{mesh}"))
        procs[f"port-{mesh}"] = _run(_PORT_DUMP, mesh, str(d / f"t{mesh}"))
    (d / "single").mkdir()
    procs["single-world"] = _run(_SINGLE_WORLD, "single", str(d / "single"))
    logs = {k: p.communicate(timeout=600)[0] for k, p in procs.items()}
    for k, p in procs.items():
        assert p.returncode == 0, f"{k}:\n{logs[k][-6000:]}"
    out = {}
    for mesh in ("single", "multi"):
        with open(d / f"j{mesh}") as f:
            out[f"jax-{mesh}"] = json.load(f)
        with open(d / f"t{mesh}") as f:
            out[f"port-{mesh}"] = json.load(f)
    with open(d / "single" / "result.json") as f:
        out["single-world"] = json.load(f)
    return out


def _default_cells():
    from repro_torch.launch.dryrun import default_cells
    return ["/".join(c) for c in default_cells()]


# -- cells against the JAX package's --------------------------------------

@pytest.mark.parametrize("mesh", ["single", "multi"])
@pytest.mark.parametrize("cell", _default_cells())
def test_cell_matches_jax(worlds, mesh, cell):
    j, t = worlds[f"jax-{mesh}"][cell], worlds[f"port-{mesh}"][cell]
    for f in ("cell_id", "skip", "note"):
        assert t[f] == j[f], f
    assert t["flops"] == pytest.approx(j["flops"], rel=1e-12, abs=0)
    assert len(t["leaves"]) == len(j["leaves"])
    for i, (a, b) in enumerate(zip(t["leaves"], j["leaves"])):
        assert a == b, (i, a, b)


def test_every_default_cell_is_built(worlds):
    cells = set(_default_cells())
    assert len(cells) == 88
    for mesh in ("single", "multi"):
        assert set(worlds[f"jax-{mesh}"]) == cells
        assert set(worlds[f"port-{mesh}"]) - {"__mesh__"} == cells


# -- make_mesh on a fake world (Part A) ------------------------------------

def test_make_mesh_on_a_fake_world(worlds):
    single = worlds["port-single"]["__mesh__"]
    multi = worlds["port-multi"]["__mesh__"]
    assert single == [{"data": 16, "model": 16}, ["data", "model"],
                      {"data": 0, "model": 0}, "cpu"]
    assert multi == [{"pod": 2, "data": 16, "model": 16},
                     ["pod", "data", "model"],
                     {"pod": 0, "data": 0, "model": 0}, "cpu"]


@pytest.mark.parametrize("backend,device", [("nccl", "cpu"),
                                            ("gloo", "cuda")])
def test_make_mesh_still_refuses_a_mismatched_backend(monkeypatch, backend,
                                                      device):
    from repro_torch.launch import mesh
    monkeypatch.setattr(mesh.tdist, "is_initialized", lambda: True)
    monkeypatch.setattr(mesh.tdist, "get_backend", lambda: backend)
    monkeypatch.setattr(mesh.tdist, "get_world_size", lambda: 1)
    monkeypatch.setattr(mesh, "_mesh_device", lambda d: torch.device(d))
    with pytest.raises(ValueError, match=f"needs the "
                       f"{'gloo' if device == 'cpu' else 'nccl'} backend"):
        mesh.make_mesh((1, 1), ("data", "model"), device=device)


# -- the dry run ------------------------------------------------------------

def test_wire_bytes_factors():
    from repro_torch.launch.dryrun import _COLL_FACTOR, wire_bytes
    c = {"all-gather": {"count": 1, "bytes": 100},
         "all-reduce": {"count": 2, "bytes": 10},
         "reduce-scatter": {"count": 1, "bytes": 7},
         "all-to-all": {"count": 1, "bytes": 3}}
    assert wire_bytes(c) == 100 + 2 * 10 + 7 + 3
    from repro.launch.dryrun import _COLL_FACTOR as JAX_FACTOR
    assert _COLL_FACTOR == JAX_FACTOR


def test_collective_log_counts_and_bytes(worlds):
    log = worlds["single-world"]["log"]
    assert log == {
        "all-gather": {"count": 2,
                       "bytes": 16 * 64 * 128 * 4 + 256 * 64 * 128 * 2},
        "reduce-scatter": {"count": 1, "bytes": 16 * 8 * 4},
        "all-to-all": {"count": 1, "bytes": 32 * 4 * 4},
        "all-reduce": {"count": 2, "bytes": 64 * 128 * 4 + 3 * 4}}


def test_registry_covers_all_assigned_cells():
    from repro_torch.configs import all_arch_ids, get_arch
    assert len(all_arch_ids()) == 10
    assert sum(len(get_arch(a).shapes) for a in all_arch_ids()) == 40


_RECORD_KEYS = {"arch", "shape", "mesh", "embedding", "ok", "cell_id",
                "note", "model_flops_per_step", "flops", "bytes_accessed",
                "memory", "collectives", "collective_wire_bytes",
                "n_devices", "wall_s"}


@pytest.mark.parametrize("cell", [
    "dlrm-rm2/serve_p99/default", "dlrm-rm2/serve_p99/full",
    "dlrm-rm2/serve_p99/hashed", "dlrm-rm2/serve_p99/tt",
    "qwen3-0.6b/decode_32k/default", "gatedgcn/molecule/default"])
def test_run_cell_records(worlds, cell):
    r = worlds["single-world"]["records"][cell]
    assert r["ok"], r.get("traceback")
    assert set(r) == _RECORD_KEYS
    assert set(r["memory"]) == {"argument_bytes", "output_bytes",
                                "temp_bytes", "alias_bytes"}
    assert r["n_devices"] == 256 and r["mesh"] == "single"
    assert r["flops"] > 0 and r["bytes_accessed"] > 0
    assert r["memory"]["argument_bytes"] > 0
    assert r["memory"]["temp_bytes"] > 0 and r["memory"]["alias_bytes"] == 0
    assert set(r["collectives"]) <= {"all-gather", "all-reduce",
                                     "reduce-scatter", "all-to-all"}
    if cell.startswith("dlrm-rm2") and not cell.endswith("full"):
        # local lookups, scores left cut over the mesh: no exchange, as
        # the JAX package's committed records show
        assert r["collectives"] == {} and r["collective_wire_bytes"] == 0
        with open(os.path.join(ROOT, "results", "dryrun",
                               "dlrm-rm2__serve_p99__multi__"
                               + cell.split("/")[-1] + ".json")) as f:
            assert json.load(f)["collectives"] == {}
    if cell.endswith("full"):
        # the row-sharded table's exchange over model
        assert r["collectives"]["reduce-scatter"]["count"] == 1
    if cell.startswith("gatedgcn"):
        assert r["collectives"]["all-reduce"]["count"] > 0


def extrapolate(p1: dict, p2: dict, k: int, n_layers: int) -> dict:
    """The JAX roofline's scan correction: probe(k+1) + (L - k - 1) ·
    (probe(k+1) - probe(k))."""
    return {f: p2[f] + (n_layers - (k + 1)) * (p2[f] - p1[f])
            for f in ("flops", "bytes_accessed", "collective_wire_bytes")}


def test_run_probe_extrapolates_to_the_full_count(worlds):
    from repro_torch.configs import get_arch
    w = worlds["single-world"]
    p1, p2 = w["probes"]
    assert p1["ok"] and p2["ok"]
    assert p2["flops"] > p1["flops"] > 0
    full = w["records"]["qwen3-0.6b/decode_32k/default"]
    n_layers = get_arch("qwen3-0.6b").make_config("full").n_layers
    got = extrapolate(p1, p2, 2, n_layers)
    for f in ("flops", "bytes_accessed", "collective_wire_bytes"):
        assert got[f] == pytest.approx(full[f], rel=1e-12), f


# -- the roofline and the report --------------------------------------------

def _synthetic(tmp_path):
    d = tmp_path / "results" / "dryrun_torch"
    d.mkdir(parents=True)
    rec = {"arch": "dlrm-rm2", "shape": "train_batch", "mesh": "multi",
           "embedding": "default", "ok": True,
           "cell_id": "dlrm-rm2/train_batch[robe]", "note": "",
           "model_flops_per_step": 512 * 989e9,
           "flops": 989e9, "bytes_accessed": 2 * 3.35e9,
           "memory": {"argument_bytes": 2e9, "output_bytes": 1e9,
                      "temp_bytes": 3e9, "alias_bytes": 0},
           "collectives": {"all-reduce": {"count": 4, "bytes": 25e6}},
           "collective_wire_bytes": 50e6, "n_devices": 512, "wall_s": 1.0}
    (d / "dlrm-rm2__train_batch__multi__default.json").write_text(
        json.dumps(rec))
    skip = {"arch": "qwen3-0.6b", "shape": "long_500k", "mesh": "multi",
            "embedding": "default", "ok": True, "skipped": "full attention",
            "cell_id": "qwen3-0.6b/long_500k[full]", "note": ""}
    (d / "qwen3-0.6b__long_500k__multi__default.json").write_text(
        json.dumps(skip))
    return tmp_path


def test_corrected_terms_and_levers_h100(tmp_path):
    from repro_torch.launch import roofline as rf
    assert (rf.PEAK_FLOPS, rf.HBM_BW, rf.LINK_BW) == (989e12, 3.35e12, 50e9)
    root = _synthetic(tmp_path)
    r = rf.corrected_terms("dlrm-rm2", "train_batch", "default", "multi",
                           results_dir=str(root / "results/dryrun_torch"))
    assert r["t_compute_s"] == pytest.approx(1e-3)
    assert r["t_memory_s"] == pytest.approx(2e-3)
    assert r["t_collective_s"] == pytest.approx(1e-3)
    assert r["dominant"] == "memory" and r["scan_corrected"] is False
    assert r["useful_ratio"] == pytest.approx(1.0)
    assert r["roofline_fraction"] == pytest.approx(0.5)
    assert r["embedding_cost"]["params"] > 0
    assert set(rf.LEVERS) == {"compute", "memory", "collective"}
    for text in rf.LEVERS.values():
        assert "MXU" not in text and "ICI" not in text
    assert rf.corrected_terms("qwen3-0.6b", "long_500k", "default", "multi",
                              results_dir=str(root / "results/dryrun_torch")
                              ) is None


def test_report_tables(tmp_path):
    from repro_torch.launch import report, roofline as rf
    root = _synthetic(tmp_path)
    r = rf.corrected_terms("dlrm-rm2", "train_batch", "default", "multi",
                           results_dir=str(root / "results/dryrun_torch"))
    r["lever"] = rf.LEVERS[r["dominant"]]
    (root / "results" / "roofline_torch").mkdir()
    (root / "results" / "roofline_torch" / "roofline.json").write_text(
        json.dumps([r, {"cell": "qwen3-0.6b/long_500k[default]",
                        "skipped": "full attention"}]))
    dry = report.dryrun_table(str(root)).splitlines()
    assert dry[0].startswith("| cell | mesh | status")
    assert "| dlrm-rm2/train_batch[default] | multi | ok | 2.00 | 3.00 | " \
        "0.99 | 0.05 |" in dry
    assert any("qwen3-0.6b/long_500k[default] | multi | SKIP" in x
               for x in dry)
    roof = report.roofline_table(str(root)).splitlines()
    assert "**memory**" in roof[2] and "| 0.500 |" in roof[2]
    assert "skipped" in roof[3]


def test_report_collectives_beside_jax(tmp_path):
    from repro_torch.launch import report
    root = _synthetic(tmp_path)
    (root / "results" / "dryrun").mkdir()
    (root / "results" / "dryrun" /
     "dlrm-rm2__train_batch__multi__default.json").write_text(json.dumps(
        {"ok": True, "collectives": {"all-reduce": {"count": 16,
                                                    "bytes": 5e7}},
         "collective_wire_bytes": 1e8}))
    rows = report.collectives_table(str(root)).splitlines()
    assert rows[2] == ("| dlrm-rm2/train_batch[default] | ar 4 | 0.050 | "
                       "ar 16 | 0.100 |")
    assert len(rows) == 3          # the skipped cell has no row


# -- Part A: the MoE's expert count, local_batch ---------------------------

@pytest.mark.parametrize("seed", range(4))
def test_expert_counts_equal_bincount(seed):
    from repro_torch.nn.moe import expert_counts
    rng = np.random.default_rng(seed)
    e = 16
    # routes that leave some experts without a token
    idx = torch.from_numpy(rng.choice(rng.permutation(e)[:e - 5],
                                      size=int(rng.integers(1, 300))))
    got = expert_counts(idx, e)
    want = torch.bincount(idx, minlength=e)
    assert got.dtype == want.dtype and torch.equal(got, want)
    assert (got == 0).sum() >= 5


def test_expert_counts_trace_under_fake_tensors():
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.nn.moe import expert_counts
    with FakeTensorMode():
        idx = torch.empty(1000, dtype=torch.int64)
        assert expert_counts(idx, 128).shape == (128,)


def test_local_batch_matches_jax():
    from repro.nn.embedding_backends import backend_names as jnames
    from repro.nn.embedding_backends import get_backend as jget
    from repro_torch.nn.embedding_backends import backend_names, get_backend
    assert set(backend_names()) == set(jnames())
    got = {n: get_backend(n).local_batch for n in backend_names()}
    assert got == {n: jget(n).local_batch for n in jnames()}
    assert got == {"full": False, "robe": True, "qrobe": True,
                   "hashed": True, "tt": True}
