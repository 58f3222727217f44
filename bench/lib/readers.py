"""What the per-layer readers share: matching kernel names in the trace,
per-unit device times, shares of the window and of a roofline.  Each
metric's own file under ``metrics/`` names its kernels and its work."""

from __future__ import annotations

from lib.work import bound_s


def matcher(names):
    return lambda kernel: any(n in kernel for n in names)


def ms_per_unit(ctx, names):
    """Device milliseconds a unit (batch, step or request) in the kernels
    named, or None when the trace holds none of them."""
    match = matcher(names)
    if not ctx.trace.count(match):
        return None
    return ctx.trace.seconds(match) * 1e3 / len(ctx.win.units)


def idle_share(ctx):
    """Per cent of the traced window in which nothing ran on the card."""
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)


def mfu(ctx, kind: str):
    """Per cent of the card's f32 peak that the model's FLOPs of the
    window's samples take over the window."""
    flops = ctx.flops[kind] * ctx.win.samples
    return 100.0 * flops / ctx.trace.window_s / ctx.rates[1]


def roofline(ctx, names, work):
    """Per cent: the least time the card could take for the work of the
    window's calls (``work(ctx, pool index)`` -> (bytes, FLOP) of one
    call) over the device time of the kernels named; None when the trace
    holds none of them."""
    match = matcher(names)
    spent = ctx.trace.seconds(match)
    if not spent:
        return None
    least = sum(bound_s(*work(ctx, i), ctx.rates) for i in ctx.win.units)
    return 100.0 * least / spent
