"""mfu.decode: the model's FLOPs of every token decoded in the traced window, over the window's seconds, as a per cent of the card's bf16 dense peak: each token's FLOPs through the weights (``archs/moonlight.py``: ``decode``) plus its absorbed attention over its own cache length, the step's position + 1 (``decode_per_key`` a position)."""

UNIT = "%"


def read(ctx):
    per_key = ctx.flops["decode_per_key"]
    flops = sum(ctx.win.sizes[u] * (ctx.flops["decode"] + per_key
                                    * (int(ctx.pool[i]["pos"][0]) + 1))
                for u, i in enumerate(ctx.win.units))
    return 100.0 * flops / ctx.trace.window_s / ctx.rates[2]
