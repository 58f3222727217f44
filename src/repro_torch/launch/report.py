"""The dry-run and roofline tables of the port (PyTorch port of
``repro.launch.report``), from results/dryrun_torch and
results/roofline_torch.

Usage: python -m repro_torch.launch.report [dryrun|roofline|both|collectives]

``collectives`` sets the port's collectives a call on the ``multi`` mesh
beside those of the JAX package's committed records (results/dryrun).
"""

from __future__ import annotations

import glob
import json
import os
import sys

ROOT = os.path.join(os.path.dirname(__file__), "..", "..", "..")


def dryrun_table(root: str = ROOT) -> str:
    rows = []
    for p in sorted(glob.glob(os.path.join(root,
                                           "results/dryrun_torch/*.json"))):
        if "probe" in p:
            continue
        with open(p) as f:
            r = json.load(f)
        cell = f"{r['arch']}/{r['shape']}[{r['embedding']}]"
        if r.get("skipped"):
            rows.append((cell, r["mesh"], "SKIP (full-attn rule)", "", "",
                         "", ""))
            continue
        if not r.get("ok"):
            rows.append((cell, r["mesh"], "FAIL", "", "", "", ""))
            continue
        m = r["memory"]
        rows.append((
            cell, r["mesh"], "ok",
            f"{m['argument_bytes'] / 1e9:.2f}",
            f"{m['temp_bytes'] / 1e9:.2f}",
            f"{(r.get('flops') or 0) / 1e12:.2f}",
            f"{(r.get('collective_wire_bytes') or 0) / 1e9:.2f}"))
    out = ["| cell | mesh | status | args GB/dev | temp GB/dev | "
           "TFLOP/dev | wire GB/dev |",
           "|---|---|---|---|---|---|---|"]
    for row in rows:
        out.append("| " + " | ".join(str(x) for x in row) + " |")
    out.append("")
    out.append("Counted on rank 0 of a fake world (FlopCounterMode, the "
               "collective log, MemTracker): every layer counted, nothing "
               "to correct.")
    return "\n".join(out)


_OPS = (("all-gather", "ag"), ("all-reduce", "ar"),
        ("reduce-scatter", "rs"), ("all-to-all", "a2a"),
        ("collective-permute", "cp"))


def _counts(colls: dict) -> str:
    return " ".join(f"{short} {colls[op]['count']}" for op, short in _OPS
                    if op in colls) or "none"


def collectives_table(root: str = ROOT, mesh: str = "multi") -> str:
    """The port's collectives a call (``results/dryrun_torch``) beside
    those in the JAX package's compiled modules (``results/dryrun``),
    cell by cell, on ``mesh``."""
    out = ["| cell | port: calls | port wire GB | JAX: ops in the HLO | "
           "JAX wire GB |", "|---|---|---|---|---|"]
    for p in sorted(glob.glob(os.path.join(
            root, f"results/dryrun_torch/*__{mesh}__*.json"))):
        if "probe" in p:
            continue
        with open(p) as f:
            r = json.load(f)
        jp = os.path.join(root, "results/dryrun", os.path.basename(p))
        if not r.get("ok") or r.get("skipped") or not os.path.exists(jp):
            continue
        with open(jp) as f:
            j = json.load(f)
        if not j.get("ok") or j.get("skipped"):
            continue
        out.append(
            f"| {r['arch']}/{r['shape']}[{r['embedding']}] | "
            f"{_counts(r['collectives'])} | "
            f"{r['collective_wire_bytes'] / 1e9:.3f} | "
            f"{_counts(j['collectives'])} | "
            f"{j['collective_wire_bytes'] / 1e9:.3f} |")
    return "\n".join(out)


def roofline_table(root: str = ROOT) -> str:
    with open(os.path.join(root, "results/roofline_torch/roofline.json")) \
            as f:
        rows = json.load(f)
    out = ["| cell | compute s | memory s | collective s | dominant | "
           "6·N·D/counted | roofline frac | lever |",
           "|---|---|---|---|---|---|---|---|"]
    for r in rows:
        if "skipped" in r:
            out.append(f"| {r['cell']} | — | — | — | skipped | — | — | "
                       f"{r['skipped'][:60]} |")
            continue
        rf = r.get("roofline_fraction")
        ur = r.get("useful_ratio")
        out.append(
            f"| {r['cell']} | {r['t_compute_s']:.3f} | "
            f"{r['t_memory_s']:.3f} | {r['t_collective_s']:.3f} | "
            f"**{r['dominant']}** | "
            f"{ur:.2f} | {rf:.3f} | {r.get('lever', '')[:70]} |"
            if ur is not None and rf is not None else
            f"| {r['cell']} | — | — | — | — | — | — | |")
    return "\n".join(out)


if __name__ == "__main__":
    which = sys.argv[1] if len(sys.argv) > 1 else "both"
    if which in ("dryrun", "both"):
        print(dryrun_table())
    if which in ("roofline", "both"):
        print()
        print(roofline_table())
    if which == "collectives":
        print(collectives_table())
