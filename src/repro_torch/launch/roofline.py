"""Roofline of the dry-run records on NVIDIA H100s (PyTorch port of
``repro.launch.roofline``).

Terms (per rank; the dry run's rank-0 run IS the per-device program):
    compute    = flops_dev / PEAK_FLOPS
    memory     = bytes_dev / HBM_BW
    collective = wire_bytes_dev / LINK_BW

The constants are the H100 SXM's (NVIDIA's H100 data sheet, SXM5 at
700 W): 989 TFLOP/s of dense bf16 on the tensor cores, 3.35 TB/s of
HBM3, and 50 GB/s a card across hosts (one 400 Gb/s NDR InfiniBand port
a card).  Every axis of the 16x16 and 2x16x16 meshes spans more than the
8 cards of one host, so NVLink's 450 GB/s each way does not bound them.

XLA's cost analysis counts a ``while`` (scan) body once, so the JAX tool
builds two shallow probes (L=k, L=k+1) and extrapolates.  The port's
layers are a Python loop that every counter sees layer by layer, so the
records need no correction: ``corrected_terms`` takes them as they are
(``scan_corrected: False``).  ``run_probe`` is kept, the same shallow
build, so that a test can show the JAX tool's extrapolation,
probe(k+1) + (L - k - 1)·(probe(k+1) - probe(k)), equals the full count.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional

PEAK_FLOPS = 989e12          # bf16 dense, tensor cores (H100 SXM, 700 W)
HBM_BW = 3.35e12             # B/s, HBM3
LINK_BW = 50e9               # B/s a card: one 400 Gb/s NDR InfiniBand port

_HERE = os.path.dirname(__file__)
RESULTS_DIR = os.path.join(_HERE, "..", "..", "..", "results",
                           "dryrun_torch")
OUT_DIR = os.path.join(_HERE, "..", "..", "..", "results", "roofline_torch")


def _load(key: str, results_dir: Optional[str] = None) -> Optional[dict]:
    p = os.path.join(results_dir or RESULTS_DIR, key + ".json")
    if os.path.exists(p):
        with open(p) as f:
            return json.load(f)
    return None


def run_probe(arch_id: str, shape_name: str, n_layers: int,
              embedding: str = "default", force: bool = False) -> dict:
    """Run a shallow-layer variant of an LM cell on the ``single`` fake
    world (this process joins it)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.configs import get_arch
    from repro_torch.dist import api as dist
    from repro_torch.launch import dryrun
    from repro_torch.launch.cells import build_lm_cell
    from repro_torch.launch.mesh import make_context

    key = (f"{arch_id}__{shape_name}__single__{embedding}"
           f"__probeL{n_layers}").replace("/", "_")
    os.makedirs(RESULTS_DIR, exist_ok=True)
    path = os.path.join(RESULTS_DIR, key + ".json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)

    bundle = get_arch(arch_id)
    rec = {"arch": arch_id, "shape": shape_name, "probe_layers": n_layers,
           "ok": False}
    try:
        dryrun.fake_world(dryrun.MESHES["single"])
        ctx = make_context(multi_pod=False, device="cpu")
        emb = "full" if embedding == "default" else embedding
        orig = bundle.make_config

        def patched(variant="full", **kw):
            kw.pop("embedding", None)
            kw["n_layers"] = n_layers
            return orig(variant, embedding=emb, **kw)

        object.__setattr__(bundle, "make_config", patched)
        try:
            with FakeTensorMode(allow_non_fake_inputs=True), dist.use(ctx):
                cell = build_lm_cell(arch_id, shape_name, ctx, emb)
                m = dryrun.measure(cell)
        finally:
            object.__setattr__(bundle, "make_config", orig)
        rec.update(ok=True, flops=m["flops"],
                   bytes_accessed=m["bytes_accessed"],
                   collectives=m["collectives"],
                   collective_wire_bytes=m["collective_wire_bytes"])
    except BaseException as e:
        rec["error"] = f"{type(e).__name__}: {e}"
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def corrected_terms(arch_id: str, shape_name: str,
                    embedding: str = "default", mesh: str = "multi",
                    results_dir: Optional[str] = None) -> Optional[dict]:
    """Roofline terms of one record (``mesh``: "single" or "multi", the
    committed 2×16×16 sweep), None when it is missing, failed or
    skipped."""
    from repro_torch.configs import get_arch
    bundle = get_arch(arch_id)
    key = f"{arch_id}__{shape_name}__{mesh}__{embedding}".replace("/", "_")
    full = _load(key, results_dir)
    if full is None or not full.get("ok") or full.get("skipped"):
        return None

    flops = full.get("flops") or 0.0
    byts = full.get("bytes_accessed") or 0.0
    wire = full.get("collective_wire_bytes") or 0.0

    emb_cost = None
    if bundle.kind == "recsys":
        # the substrate's own cost model (params / HBM bytes / flops per
        # step), read from the backend, not recomputed here
        from repro_torch.nn.embedding_backends import get_backend
        emb_name = {"default": "robe", "full2d": "full"}.get(embedding,
                                                             embedding)
        spec = bundle.make_config("full",
                                  embedding=emb_name).embedding_spec()
        shp = bundle.shapes[shape_name]
        b = shp.get("batch") or shp.get("n_candidates") or 0
        emb_cost = get_backend(spec.kind).cost(spec, b)

    t_compute = flops / PEAK_FLOPS
    t_memory = byts / HBM_BW
    t_coll = wire / LINK_BW
    dominant = max(("compute", t_compute), ("memory", t_memory),
                   ("collective", t_coll), key=lambda kv: kv[1])[0]
    model_flops = full.get("model_flops_per_step") or 0.0
    n_dev = full.get("n_devices", 256)
    flops_global = flops * n_dev
    top = max(t_compute, t_memory, t_coll)
    return {
        "cell": f"{arch_id}/{shape_name}[{embedding}]",
        "mesh": mesh,
        "flops_dev": flops, "bytes_dev": byts, "wire_dev": wire,
        "t_compute_s": t_compute, "t_memory_s": t_memory,
        "t_collective_s": t_coll, "dominant": dominant,
        "model_flops": model_flops,
        "useful_ratio": (model_flops / flops_global
                         if flops_global else None),
        "roofline_fraction": t_compute / top if top > 0 else None,
        "mem_args_gb": full["memory"]["argument_bytes"] / 1e9,
        "mem_temp_gb": full["memory"]["temp_bytes"] / 1e9,
        "scan_corrected": False,
        "embedding_cost": emb_cost,
        "note": full.get("note", ""),
    }


LEVERS = {
    "compute": "raise tensor-core use: bf16 GEMMs instead of f32 SIMT "
               "ones, larger per-card tiles, fewer recompute passes "
               "(remat), fused attention",
    "memory": "cut HBM traffic: fuse the elementwise chains eager PyTorch "
              "runs one kernel each, bf16 activations end to end, "
              "gather+reduce in one kernel (robe_lookup, serve_fused)",
    "collective": "cut InfiniBand bytes: reduce-scatter instead of "
                  "all-reduce, bucket the per-leaf gradient all-reduces, "
                  "keep the model axis inside one host's NVLink, overlap "
                  "the MoE all_to_alls with expert compute",
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="multi", choices=["single", "multi"])
    ap.add_argument("--write", default=os.path.join(OUT_DIR,
                                                    "roofline.json"))
    args = ap.parse_args(argv)
    from repro_torch.configs import all_arch_ids, get_arch

    rows = []
    for arch in all_arch_ids():
        bundle = get_arch(arch)
        for shape in bundle.shapes:
            embs = ["default"] + (["full", "hashed", "tt"]
                                  if bundle.kind == "recsys" else [])
            for e in embs:
                r = corrected_terms(arch, shape, e, mesh=args.mesh)
                if r is None:
                    key = f"{arch}__{shape}__{args.mesh}__{e}".replace(
                        "/", "_")
                    raw = _load(key)
                    if raw and raw.get("skipped"):
                        rows.append({"cell": f"{arch}/{shape}[{e}]",
                                     "skipped": raw["skipped"]})
                    continue
                r["lever"] = LEVERS[r["dominant"]]
                rows.append(r)
                print(f"{r['cell']:55s} C={r['t_compute_s']*1e3:9.3f}ms "
                      f"M={r['t_memory_s']*1e3:9.3f}ms "
                      f"N={r['t_collective_s']*1e3:9.3f}ms "
                      f"dom={r['dominant']:10s} "
                      f"useful={r['useful_ratio'] or 0:.2f}", flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.write)), exist_ok=True)
    with open(args.write, "w") as f:
        json.dump(rows, f, indent=1)
    print(f"wrote {args.write} ({len(rows)} rows)")


if __name__ == "__main__":
    main()
