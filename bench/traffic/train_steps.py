"""Driver ``train_steps``: training in fixed labelled batches.

The traffic file gives ``batch``, ``pool`` (distinct labelled batches
made at set-up from the seed), ``check_steps`` and ``trace_seconds``.
Set-up drives the entry's one train state through its first
``check_steps`` steps, on the pool's first batches (rows that all
differ), through the same call the window makes, and keeps the loss of
each and the parameters after the first and the last of them; the window
goes on from there with the same object, cycling the pool.  Each step
copies its batch to the card; nothing waits for the card inside the
window but the copies, and the window ends when the card has finished
its last step.  End to end: ``train_samples_per_s``.

The check follows ``check_steps`` steps of the reference from the same
weights and batches (SGD: ``p - lr * g``) and compares the loss of each
step, the norm of each leaf's first-step gradient (the program's worked
out from its parameters after one step: (p0 - p1) / lr) and the norm of
each leaf's change over the steps.  A leaf's gap is the difference of the
two norms over the reference's norm of that leaf or of the median leaf,
whichever is larger.  ``grad_gap`` and ``update_gap`` are the worst
leaf's.  ``grad_median_vs_f32`` is the median leaf's first-step gap in
units of float32's own: over the same median gap between the float32
reference and a float64 one.  It is the reading steady from seed to seed:
where a seed's gradient is a sum that nearly cancels, float32 rounding
moves every gap a hundredfold however the sum is ordered, and TF32 moves
the median leaf some twenty times as far as float32 does (``PERF.md``).
Leaves whose reference gradient is
under a thousandth of the median leaf's would move by rounding alone,
and are left out.
"""

from __future__ import annotations

import statistics
import sys
import time

import torch

from lib import stream
from lib.window import Window
from reference import models as ref

#: a leaf whose reference gradient norm is under this share of the median
#: leaf's is left out of the gradient and change readings
DEGENERATE = 1e-3


def inputs(cfg: dict, traffic: dict, seed: int) -> list:
    return [stream.batch_at(cfg["vocab_sizes"], cfg.get("n_dense", 0),
                            traffic["batch"], seed, k)
            for k in range(traffic["pool"])]


def _clone(tree):
    leaves, unflat = ref.flatten(tree)
    return unflat([x.detach().clone() for x in leaves])


def prepare(entry, pool: list, traffic: dict) -> dict:
    n = traffic["check_steps"]
    if len(pool) < n:
        raise ValueError("the pool must hold a distinct batch for every "
                         "checked step")
    losses = []
    for k in range(n):
        losses.append(entry.step(pool[k])["loss"])
        if k == 0:
            p1 = _clone(entry.params())
    pn = _clone(entry.params())
    return {"losses": [float(x) for x in losses], "p1": p1, "pn": pn,
            "start": n}


def window(entry, pool: list, seconds: float, span, prep: dict
           ) -> Window:
    start = prep["start"]
    units, sizes, enq, finite = [], [], [], []
    sync = torch.cuda.synchronize if torch.cuda.is_available() else (
        lambda: None)
    sync()
    t0 = time.perf_counter()
    with span("bench.window"):
        while True:
            i = (start + len(units)) % len(pool)
            ts = time.perf_counter()
            with span("bench.unit"):
                m = entry.step(pool[i])
            t = time.perf_counter()
            enq.append(t - ts)
            finite.append(m["finite"])
            units.append(i)
            sizes.append(pool[i]["sparse"].shape[0])
            if t - t0 >= seconds:
                break
        sync()
        t = time.perf_counter()
    failed = int(len(finite) - float(torch.stack(finite).sum()))
    return Window(units=units, sizes=sizes, elapsed=t - t0, enqueue=enq,
                  failed=failed)


def end_to_end(win: Window) -> dict:
    return {"train_samples_per_s": (win.samples / win.elapsed, "samples/s")}


def _norms(tree) -> list:
    return [float(torch.linalg.vector_norm(x.to(torch.float64)))
            for x in ref.flatten(tree)[0]]


def _gaps(prog: list, refn: list, keep: list) -> list:
    """Each kept leaf's gap of norms, NaN read as infinite."""
    med = statistics.median(refn[i] for i in keep)
    out = []
    for i in keep:
        g = abs(prog[i] - refn[i]) / max(refn[i], med)
        out.append(g if g == g else float("inf"))
    return out


def _f64(tree):
    leaves, unflat = ref.flatten(tree)
    return unflat([x.to(torch.float64) for x in leaves])


def _worst(gaps: list, keep: list, names: list, what: str) -> float:
    j = max(range(len(gaps)), key=gaps.__getitem__)
    print(f"{what}: worst leaf {names[keep[j]]}", file=sys.stderr)
    return gaps[j]


def checks(win: Window, pool: list, traffic: dict, seed: int, prep: dict,
           reference) -> dict:
    cfg, dev = reference.cfg, reference.device
    lr = cfg["optimizer"]["lr"]
    if cfg["optimizer"]["kind"] != "sgd":
        raise ValueError("the train check works the gradient out of an SGD "
                         "step")
    p0 = reference.params
    p, ref_losses = p0, []
    for k in range(traffic["check_steps"]):
        loss, g = ref.loss_and_grad(p, cfg, pool[k], dev)
        if k == 0:
            g1 = g
        ref_losses.append(loss)
        p = ref.sgd(p, g, lr)
    leaves0, unflat = ref.flatten(p0)
    g1_prog = unflat([(a - b) / lr for a, b in
                      zip(leaves0, ref.flatten(prep["p1"])[0])])
    dn_prog = unflat([b - a for a, b in
                      zip(leaves0, ref.flatten(prep["pn"])[0])])
    dn_ref = unflat([b - a for a, b in zip(leaves0, ref.flatten(p)[0])])
    names = ref.leaf_names(p0)
    g_ref = _norms(g1)
    med = statistics.median(g_ref)
    keep = [i for i, n in enumerate(g_ref) if n >= DEGENERATE * med]
    if len(keep) < len(g_ref):
        print("left out (gradient nought to rounding): "
              + ", ".join(names[i] for i in range(len(names))
                          if i not in keep), file=sys.stderr)
    loss_gap = max(abs(a - b) / abs(b)
                   for a, b in zip(prep["losses"], ref_losses))
    if not loss_gap == loss_gap:
        loss_gap = float("inf")
    batch64 = {k: v.astype("float64") if k == "dense" else v
               for k, v in pool[0].items()}
    g64 = _norms(ref.loss_and_grad(_f64(p0), cfg, batch64, dev)[1])
    grad = _gaps(_norms(g1_prog), g_ref, keep)
    f32 = statistics.median(_gaps(g_ref, g64, keep))
    print(f"grad median gap {statistics.median(grad)!r}, float32's own "
          f"{f32!r}", file=sys.stderr)
    upd = _gaps(_norms(dn_prog), _norms(dn_ref), keep)
    return {"loss_gap": loss_gap,
            "grad_gap": _worst(grad, keep, names, "grad_gap"),
            "grad_median_vs_f32": statistics.median(grad) / max(f32, 1e-12),
            "update_gap": _worst(upd, keep, names, "update_gap"),
            "failed": win.failed}
