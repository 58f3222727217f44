"""Dry run of every (arch x shape x mesh) cell on a fake world (PyTorch
port of ``repro.launch.dryrun``).

The JAX dry run lowers and compiles each cell for 256 or 512 forced host
devices and reads the compiled module: ``memory_analysis()``,
``cost_analysis()`` and the collectives in the post-SPMD HLO.  This is
its counterpart: the process joins a ``fake`` process group
(``torch.testing._internal.distributed.fake_pg``) as rank 0 of a world of
256 (``single``, 16x16) or 512 (``multi``, 2x16x16) ranks and runs the
cell's step once as that rank, every tensor a fake one
(``FakeTensorMode``).  Rank 0's run is the per-device program, as the
SPMD HLO is in JAX.  Nothing is allocated, no byte moves and no kernel
runs (on fake tensors every op of ``kernels/ops.py`` takes its plain
version); collectives return at once.  A process holds one world, so
each mesh runs in a process of its own (``--mesh both`` starts one for
each).

Each figure of a record comes from a counter of that one run:

* ``flops``: ``torch.utils.flop_counter.FlopCounterMode``;
* ``bytes_accessed``: the input and output bytes of every aten op
  (``_bytes_mode``; views move nothing and are left out; eager PyTorch
  fuses nothing, so this is the traffic of the unfused program);
* ``memory.temp_bytes``: the peak of ``MemTracker``
  (``torch.distributed._tools.mem_tracker``) over the tensors the run
  allocates, its outputs among them;
* ``memory.argument_bytes`` / ``output_bytes``: the bytes of the rank's
  shards of the inputs (by the cell's ``in_shardings``; the port's rank
  also receives the whole batch, contract point 1 of ``dist.api``) and
  of its outputs; ``alias_bytes`` 0 (eager PyTorch donates nothing);
* ``collectives``: ``dist.collectives``' log, ``counts`` and ``nbytes``
  (each call's output bytes: the quantity the JAX dry run sums from the
  HLO), under the HLO's names.

The JAX module's ``parse_collectives``, ``_shape_bytes`` and
``cost_dict`` read HLO text and XLA objects, which the port has none of:
the collective log takes their place.

Results cache to results/dryrun_torch/<cell>.json (a failure is recorded
there with its traceback; the sweep goes on); the roofline report
(``launch/roofline.py``) reads them.

Usage:
  python -m repro_torch.launch.dryrun                  # all cells, both meshes
  python -m repro_torch.launch.dryrun --arch dlrm-rm2 --shape train_batch \\
        --mesh single --embedding full
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")

# collectives and the per-device wire-byte factor applied to the op's
# OUTPUT bytes (ring algorithms), as the JAX dry run takes them
_COLL_FACTOR = {
    "all-gather": 1.0,          # receives (n-1)/n · out ≈ out
    "all-reduce": 2.0,          # reduce-scatter + all-gather
    "reduce-scatter": 1.0,      # sends (n-1)/n · in ≈ out · n ≈ … use out·1?
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}

# ``dist.collectives``' names -> the HLO's
_HLO_NAME = {"all_gather": "all-gather", "all_reduce": "all-reduce",
             "reduce_scatter": "reduce-scatter", "all_to_all": "all-to-all"}

MESHES = {"single": 256, "multi": 512}


def wire_bytes(colls: dict) -> float:
    return sum(_COLL_FACTOR.get(op, 1.0) * rec["bytes"]
               for op, rec in colls.items())


def collective_log() -> dict:
    """``dist.collectives``' calls and output bytes since their last
    clear, {hlo op name: {"count", "bytes"}}."""
    from repro_torch.dist import collectives as coll
    return {_HLO_NAME.get(op, op): {"count": int(n),
                                    "bytes": int(coll.nbytes[op])}
            for op, n in sorted(coll.counts.items()) if n}


def _tensor_bytes(tree) -> int:
    import torch
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(_tensor_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tensor_bytes(v) for v in tree)
    return 0


def _shard_bytes(cell) -> int:
    """The bytes of the rank's shards of every input, by
    ``in_shardings``."""
    from repro_torch.tree import leaves, leaves_up_to
    n = 0
    for a, s in zip(cell.arg_shapes, cell.in_shardings):
        for x, sh in zip(leaves(a), leaves_up_to(a, s)):
            if x is not None:
                n += _tensor_bytes(x if sh is None else sh.cut(x))
    return n


def _bytes_mode():
    """A dispatch mode that sums the input and output bytes of every aten
    op (views and allocations left out; the collectives and ``prim``
    metadata queries are no aten ops)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    class _BytesMode(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.total = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if not (func.namespace != "aten"
                    or getattr(func, "is_view", False)
                    or func.overloadpacket.__name__ in (
                        "empty", "empty_like", "empty_strided", "detach",
                        "lift_fresh", "_local_scalar_dense")):
                for x in tree_leaves((args, kwargs, out)):
                    if isinstance(x, torch.Tensor):
                        self.total += x.numel() * x.element_size()
            return out

    return _BytesMode()


def fake_world(n: int) -> None:
    """Join a fake world of ``n`` ranks as rank 0 (once a process)."""
    import torch.distributed as tdist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if tdist.is_initialized():
        if tdist.get_world_size() != n or tdist.get_backend() != "fake":
            raise RuntimeError(
                f"this process holds a world of {tdist.get_world_size()} "
                f"({tdist.get_backend()}); a fake world of {n} needs a "
                f"process of its own")
        return
    tdist.init_process_group("fake", store=FakeStore(), rank=0,
                             world_size=n)


def measure(cell) -> dict:
    """Run a built cell once as this rank under the counters (the caller
    holds the fake mode the cell's inputs live in and the context)."""
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.dist import collectives as coll
    from repro_torch.launch.cells import rank_args

    args = rank_args(cell)
    coll.counts.clear()
    coll.nbytes.clear()
    flop, byts, mem = FlopCounterMode(display=False), _bytes_mode(), \
        MemTracker()
    with mem, flop, byts:
        out = cell.fn(*args)
    peak = sum(v.get("Total", 0) for v in
               mem.get_tracker_snapshot("peak").values())
    colls = collective_log()
    return {"flops": float(flop.get_total_flops()),
            "bytes_accessed": float(byts.total),
            "memory": {"argument_bytes": _shard_bytes(cell),
                       "output_bytes": _tensor_bytes(out),
                       "temp_bytes": int(peak),
                       "alias_bytes": 0},
            "collectives": colls,
            "collective_wire_bytes": wire_bytes(colls)}


def _key(arch_id, shape_name, mesh_name, embedding):
    return f"{arch_id}__{shape_name}__{mesh_name}__{embedding}".replace(
        "/", "_")


def run_cell(arch_id: str, shape_name: str, multi_pod: bool,
             embedding: str = "default", force: bool = False,
             save_hlo: bool = False) -> dict:
    """The record of one cell on the ``multi`` (512 ranks) or ``single``
    (256) fake world; served from ``results/dryrun_torch/`` unless
    ``force``."""
    mesh_name = "multi" if multi_pod else "single"
    os.makedirs(RESULTS_DIR, exist_ok=True)
    path = os.path.join(RESULTS_DIR, _key(arch_id, shape_name, mesh_name,
                                          embedding) + ".json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)

    rec = {"arch": arch_id, "shape": shape_name, "mesh": mesh_name,
           "embedding": embedding, "ok": False}
    t0 = time.time()
    try:
        from torch._subclasses.fake_tensor import FakeTensorMode
        from repro_torch.dist import api as dist
        from repro_torch.launch.cells import build_cell
        from repro_torch.launch.mesh import make_context

        fake_world(MESHES[mesh_name])
        ctx = make_context(multi_pod=multi_pod, device="cpu")
        with FakeTensorMode(allow_non_fake_inputs=True), dist.use(ctx):
            cell = build_cell(arch_id, shape_name, ctx, embedding)
            rec["cell_id"] = cell.cell_id
            rec["note"] = cell.note
            if cell.skip:
                rec.update(ok=True, skipped=cell.skip)
            else:
                rec["model_flops_per_step"] = cell.model_flops_per_step
                rec.update(measure(cell))
                rec.update(ok=True, n_devices=ctx.n_devices)
    except BaseException as e:       # record the failure, keep sweeping
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    rec["wall_s"] = round(time.time() - t0, 1)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def default_cells():
    """The 40 assigned cells (+ recsys embedding-substrate variants)."""
    from repro_torch.configs import all_arch_ids, get_arch
    cells = []
    for arch in all_arch_ids():
        bundle = get_arch(arch)
        for shape in bundle.shapes:
            cells.append((arch, shape, "default"))
            if bundle.kind == "recsys":
                # the paper's full-table baseline + the community
                # compression baselines, through the same cells
                for emb in ("full", "hashed", "tt"):
                    cells.append((arch, shape, emb))
    return cells


def _each_mesh(argv, meshes) -> int:
    """Run this CLI once a mesh, each in a process of its own, side by
    side; the worst exit code."""
    src = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=src + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, "-m",
                               "repro_torch.launch.dryrun"] + argv
                              + ["--mesh", m], env=env) for m in meshes]
    return max(p.wait() for p in procs)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both", choices=["single", "multi",
                                                       "both"])
    ap.add_argument("--embedding", default=None)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--save-hlo", action="store_true")
    argv = sys.argv[1:] if argv is None else list(argv)
    args = ap.parse_args(argv)
    if args.save_hlo:
        print("--save-hlo: the port compiles no module, so there is no HLO "
              "to save; the records hold the counters' figures",
              file=sys.stderr)
    if args.mesh == "both":
        rest, skip = [], False
        for a in argv:               # the same flags, less --mesh
            if skip:
                skip = False
            elif a == "--mesh":
                skip = True
            elif not a.startswith("--mesh="):
                rest.append(a)
        return _each_mesh(rest, ["single", "multi"])

    cells = default_cells()
    if args.arch:
        cells = [c for c in cells if c[0] == args.arch]
    if args.shape:
        cells = [c for c in cells if c[1] == args.shape]
    if args.embedding:
        cells = [(a, s, args.embedding) for a, s, _ in cells]
        cells = list(dict.fromkeys(cells))
    mp = args.mesh == "multi"
    for arch, shape, emb in cells:
        rec = run_cell(arch, shape, mp, emb, force=args.force,
                       save_hlo=args.save_hlo)
        status = ("SKIP " + rec.get("skipped", "")[:40]) if \
            rec.get("skipped") else \
            ("OK" if rec.get("ok") else "FAIL " + rec.get("error",
                                                          "")[:80])
        print(f"[{args.mesh:6s}] {arch}/{shape}[{emb}]: {status} "
              f"({rec.get('wall_s', 0)}s)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
