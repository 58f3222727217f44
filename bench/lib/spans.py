"""Reading the program's own spans (``repro_torch.tracing``) of the traced
window: each unit's root span (``server.score`` a request or batch,
``train.step`` a step) and the spans under it.

The traced window is the only part of a run under the profiler, and the
program records spans only there, so the last roots of a kind, one a
unit of the window, are the window's own (a retried trace runs the window
again).  Each root counts the rows it scored or trained on (``samples``),
and they have to equal the window's sizes one for one, unit by unit: that
proves the roots are the window's.  A program that records no spans, or
roots that do not match the window, gives None: the metric stays out of
the line.
"""

from __future__ import annotations


def window_spans(ctx, root: str):
    """(roots, {root id: its descendants}) of the window's units, oldest
    first, or None."""
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    recs = tracing.records()
    n = len(ctx.win.units)
    roots = [r for r in recs if r.name == root and r.parent is None][-n:]
    if not n or [r.counts.get("samples") for r in roots] != \
            [int(k) for k in ctx.win.sizes]:
        return None
    ids = {r.id: [] for r in roots}
    for r in recs:
        if r.request in ids and r.id != r.request:
            ids[r.request].append(r)
    return roots, ids


def ms(r) -> float:
    return (r.end_ns - r.start_ns) * 1e-6


def root_ms(ctx, root: str):
    """Mean host milliseconds of the window's ``root`` spans, or None."""
    got = window_spans(ctx, root)
    if got is None:
        return None
    return sum(ms(r) for r in got[0]) / len(got[0])


def child_ms(ctx, root: str, child: str):
    """Mean over the window's units of the host milliseconds in the
    ``child`` spans under each ``root``, or None."""
    got = window_spans(ctx, root)
    if got is None:
        return None
    roots, kids = got
    spans = [k for r in roots for k in kids[r.id] if k.name == child]
    if not spans:
        return None
    return sum(ms(k) for k in spans) / len(roots)


def child_count(ctx, root: str, child: str, key: str):
    """The window's total of the count ``key`` of the ``child`` spans, or
    None."""
    got = window_spans(ctx, root)
    if got is None:
        return None
    roots, kids = got
    counts = [k.counts[key] for r in roots for k in kids[r.id]
              if k.name == child and key in k.counts]
    return sum(counts) if counts else None
