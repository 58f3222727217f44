"""Count the global atomics each element of the sparse backwards' gradients
receives, on one card.

    python3 tools/atomic_chains.py [B]

Builds a counting copy of ``src/repro_torch/kernels/csrc`` under
``build/atomic_chains/``: every global atomic of a backward into a
gradient adds 1 instead of its value, under the same condition -- the
scatter's ``atomicAdd(ws + slot, val)`` in robe_scatter.cuh
(robe_lookup_bwd's); in qrobe_lookup_bwd.cu the flush's REDs into
delta's gradient, ``atomicAdd(ws + slot, a)``, and its one atomic a scale
group and line, ``atomicAdd(ws_scale + grp, x)``; the walk's
``atomicAdd(dst + x, v)`` in qr_lookup_bwd.cu, which sends both its dR and its dQ rows; in
tt_lookup_bwd.cu the first design's ``atomicAdd(dst + e, sa[e])`` and
the ranked walk's four (its core1 run's ``v``, its core2 sums
``acc3[s]``, its core0 slots' ``v`` where a block has no copy of core0's
gradient, and the flush of that copy, ``atomicAdd(dst + e, v)``).  Sums
a kernel keeps in registers or shared memory before these, the adds into
the block's copy (``atomicAdd(sm0 + ...)``) among them, are not atomics
of a gradient and are not counted.
Each f32 gradient the wrappers return then holds, element by element, the
number of atomics it received.  Runs robe_lookup_bwd, qrobe_lookup_bwd
(delta's gradient and the scales', f32), qr_lookup_bwd and
tt_lookup_bwd in f32 on chip_smoke.py's zipf batch of B (default 65,536)
full-width ``dlrm-criteo-tb`` ids with a random g, and prints, per
gradient table, the most atomics one element received and their total,
beside the most terms one element sums (the chain if nothing were
combined, counted from the ids).  The sort passes' integer counters
(row_sort.cuh) are not counted.  Needs one CUDA card and nvcc.
"""

from __future__ import annotations

import json
import re
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "atomic_chains"
#: file of csrc/ -> the atomics into a gradient it holds
SITES = {"robe_scatter.cuh": 1, "qrobe_lookup_bwd.cu": 4,
         "qr_lookup_bwd.cu": 1, "tt_lookup_bwd.cu": 5}
#: a global gradient atomic: into ws or dst
ATOMIC = re.compile(r"atomicAdd\(((?:ws|dst)\w* \+ [^;]*?), ([\w\[\]]+)\);")


def counting_copy(csrc: Path, out: Path) -> Path:
    """A copy of ``csrc`` in ``out`` whose gradient atomics add 1."""
    if out.exists():
        shutil.rmtree(out)
    shutil.copytree(csrc, out)
    for f in sorted(out.iterdir()):
        text, n = ATOMIC.subn(r"atomicAdd(\1, 1.f);", f.read_text())
        if n != SITES.get(f.name, 0):
            raise SystemExit(f"{f.name}: {n} gradient atomics, expected "
                             f"{SITES.get(f.name, 0)}")
        f.write_text(text)
    return out


def counts(c, terms) -> dict:
    """The atomics ``c`` (one count per element) and ``terms``, the most
    terms one element sums."""
    import torch
    if not (torch.equal(c, c.round()) and bool((c >= 0).all())):
        raise SystemExit("a gradient holds no atomic counts: the counting "
                         "build did not take")
    return {"most_on_one_element": int(c.max()),
            "element": int(c.argmax()), "total": int(c.double().sum()),
            "most_terms_one_element": int(terms)}


def main() -> int:
    b = int(sys.argv[1]) if len(sys.argv) > 1 else 65536
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("atomic_chains: no CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.core.robe import robe_slots
    from repro_torch.kernels import (_build, qr_lookup_bwd_cuda,
                                     qrobe_lookup_bwd_cuda,
                                     robe_lookup_bwd_cuda, tt_lookup_bwd_cuda)
    from repro_torch.kernels.ref import qr_indices, tt_indices

    _build.CSRC = counting_copy(_build.CSRC, OUT / "csrc")
    lib = _build.build(OUT / "lib")
    _build.build = lambda build_dir=None: lib     # what the wrappers load
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED)
    cfg = cs.server_config()
    subs = cs.substrate_server(cfg)
    spec = cfg.recsys_cfg("robe").embedding_spec().robe
    qspec = subs.recsys_config("qrobe").embedding_spec().robe
    tids = tuple(range(cs.F))
    rows = cs.bulk_inputs(gen, dev, b, 1)[0]
    g = torch.randn((b, cs.F, cs.D), generator=gen, device=dev)

    def slot_terms(sp, shift: int = 0) -> int:
        """The most (item, element) pairs of the batch that read one slot
        (one group of 2^shift slots)."""
        n = torch.zeros(((sp.size - 1) >> shift) + 1, dtype=torch.int64,
                        device=dev)
        t = torch.arange(cs.F, device=dev)[None, :]
        for s in range(0, b, 8192):
            n += torch.bincount(robe_slots(sp, t, rows[s:s + 8192],
                                           cs.D).flatten() >> shift,
                                minlength=n.numel())
        return int(n.max())

    def most(keys) -> int:
        return int(torch.bincount(keys.flatten().long()).max())

    res = {"robe_lookup_bwd": {"M": counts(
        robe_lookup_bwd_cuda(g, rows, tids, cs.D, spec), slot_terms(spec))}}
    qp = subs.params("qrobe")["embedding"]
    gscale, gdelta = qrobe_lookup_bwd_cuda(g, qp["codes"], rows, tids, cs.D,
                                           qspec, cs.GROUP_LOG2)
    res["qrobe_lookup_bwd"] = {
        "delta": counts(gdelta, slot_terms(qspec)),
        "scale": counts(gscale, slot_terms(qspec, cs.GROUP_LOG2))}
    hp = subs.params("hashed")["embedding"]
    q_off, r_off, m = cs.qr_args(subs)
    dq, dr = qr_lookup_bwd_cuda(g, hp["q_table"], hp["r_table"], rows, q_off,
                                r_off, m)
    qi, ri = qr_indices(rows, q_off, r_off, m)
    res["qr_lookup_bwd"] = {"Q": counts(dq, most(qi)),
                            "R": counts(dr, most(ri))}
    tp = subs.params("tt")["embedding"]
    offsets, factors = cs.tt_args(subs)
    cores = (tp["core0"], tp["core1"], tp["core2"])
    grads = tt_lookup_bwd_cuda(g, *cores, rows, offsets, factors)
    res["tt_lookup_bwd"] = {
        f"core{k}": counts(c, most(i)) for k, (c, i) in
        enumerate(zip(grads, tt_indices(rows, offsets, factors)))}
    for kernel, tables in res.items():
        for table, r in tables.items():
            print(f"{kernel} {table}: at most {r['most_on_one_element']} "
                  f"atomics on one element ({r['most_terms_one_element']} "
                  f"terms uncombined), {r['total']} in all")
    print(json.dumps({"atomic_chains": res, "batch": b,
                      "card": cs.nvidia_smi()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
