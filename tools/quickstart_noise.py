"""Repeat chip_smoke.py's quickstart training check on one card.

    python3 tools/quickstart_noise.py [N] [ROOT]

Runs ``quickstart_path`` of the ``chip_smoke.py`` at ROOT (this checkout
by default; another, such as ``git archive <commit> | tar -x -C
build/old``, to compare two trees' kernels on one card) N times (default
6) in one process and prints, per run, the largest per-leaf update error
(card step against the CPU step from the same state), its leaf, the
held-out AUC and the free runs' largest loss difference, or the check's
failure; then one JSON line.  The spread shows how far summation order
alone (atomics, cuBLAS against the CPU's GEMMs) moves those readings.
Needs one CUDA card and nvcc.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path


def main() -> int:
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 6
    root = Path(sys.argv[2] if len(sys.argv) > 2 else
                Path(__file__).resolve().parents[1]).resolve()
    sys.path.insert(0, str(root))
    import torch
    if not torch.cuda.is_available():
        print("quickstart_noise: no CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs._build.library()
    runs = []
    for k in range(n):
        t0 = time.perf_counter()
        try:
            r = cs.quickstart_path()
            err = r["update_rel_err"]
            leaf = max(err, key=err.get)
            runs.append({"max_update_err": err[leaf], "leaf": leaf,
                         "auc": r["auc"], "auc_cpu": r["auc_cpu"],
                         "max_free_loss_diff": r["max_free_loss_diff"]})
        except cs.SmokeFailure as e:
            runs.append({"failed": str(e)})
        print(k, round(time.perf_counter() - t0, 1), runs[-1], flush=True)
    print(json.dumps({"root": str(root), "card": cs.nvidia_smi(),
                      "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
