"""Repeat chip_smoke.py's training checks on one card.

    python3 tools/quickstart_noise.py [N] [ROOT] [--kinds robe,qrobe,...]
                                      [--full-width]

Runs ``quickstart_path(kind)`` of the ``chip_smoke.py`` at ROOT (this
checkout by default; another, such as ``git archive <commit> | tar -x -C
build/old``, to compare two trees' kernels on one card) N times (default
6) for each substrate of ``--kinds`` (default robe) in one process, and
with ``--full-width`` also ``full_width_path`` on the full-width
``dlrm-criteo-tb`` weights of each.  Prints, per run, the check's
per-step update reading (card step against the CPU step from the same
state, per param leaf: the largest median over the steps, the steps above
the flag bound and their leaves, the whole run's reading, which does not
gate), qrobe's codes that the card's steps set otherwise than the CPU's,
robe's held-out AUCs and free runs' largest loss difference, or the
check's failure; then one JSON line with the count of runs that passed,
per check.  The spread shows how far summation order alone (atomics,
cuBLAS against the CPU's GEMMs) moves those readings.  Needs one CUDA
card and nvcc.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path


def summary(r: dict, key: str) -> dict:
    """The update reading of one check's result ``r`` (under ``key``)."""
    u = r[key]
    whole = u["whole_run"]
    return {"max_median": u["max_median"],
            "flagged_steps": u["flagged_steps"],
            "flagged": [(f["step"], f["leaf"], f["reading"])
                        for f in u["flagged"]],
            "whole_run_max": max(whole.values()),
            "whole_run_leaf": max(whole, key=whole.get)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", nargs="?", type=int, default=6)
    ap.add_argument("root", nargs="?",
                    default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--kinds", default="robe")
    ap.add_argument("--full-width", action="store_true")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    kinds = args.kinds.split(",")
    sys.path.insert(0, str(root))
    import torch
    if not torch.cuda.is_available():
        print("quickstart_noise: no CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.tree import tree_map
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs._build.library()
    full = {}
    if args.full_width:
        cfg = cs.server_config()
        servers = {"robe": cs.EmbeddingServer(cfg, device="cuda")}
        if set(kinds) - {"robe"}:
            subs = cs.substrate_server(cfg)
            servers.update({k: subs for k in cs.SUBSTRATES})
        full = {k: (servers[k].recsys_config(k), servers[k].params(k))
                for k in kinds}
    runs = {}
    for k in range(args.n):
        for kind in kinds:
            checks = [("quickstart", lambda: cs.quickstart_path(kind))]
            if kind in full:
                checks.append(("full_width", lambda: cs.full_width_path(
                    full[kind][0], tree_map(torch.clone, full[kind][1]),
                    kind)))
            for what, fn in checks:
                t0 = time.perf_counter()
                try:
                    r = fn()
                    if what == "quickstart":
                        row = summary(r, "update")
                        row.update({n: r[n] for n in (
                            "codes_differing_from_cpu_steps", "auc",
                            "auc_cpu", "max_free_loss_diff") if n in r})
                    else:
                        row = summary(r, "sgd_b512_update")
                        row.update({n: r[n] for n in (
                            "sgd_b512_max_param_diff",
                            "sgd_b512_codes_differing_from_cpu_steps")
                            if n in r})
                except cs.SmokeFailure as e:
                    row = {"failed": str(e)}
                runs.setdefault(f"{what}_{kind}", []).append(row)
                print(k, what, kind, round(time.perf_counter() - t0, 1), row,
                      flush=True)
    print(json.dumps({"root": str(root), "card": cs.nvidia_smi(),
                      "passed": {c: sum("failed" not in r for r in rs)
                                 for c, rs in runs.items()},
                      "repeats": args.n, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
