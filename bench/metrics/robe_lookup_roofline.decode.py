"""robe_lookup_roofline.decode: the least time of the ROBE token lookup (kernels/csrc/robe_lookup.cu) on each step's own token ids over its device time, per cent: the ids (int32) read, the bf16 slots they reach read once, [rows, d] bf16 written; no FLOPs."""

UNIT = "%"
KERNELS = ("robe_lookup_kernel",)


def read(ctx):
    match = lambda k: any(n in k for n in KERNELS)
    spent = ctx.trace.seconds(match)
    if not spent:
        return None
    d = ctx.cfg["hidden_size"]
    least = sum((b * 4 + ctx.touched(i) * 2 + b * d * 2) / ctx.rates[0]
                for i, b in zip(ctx.win.units, ctx.win.sizes))
    return 100.0 * least / spent
