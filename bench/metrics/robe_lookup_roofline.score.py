"""robe_lookup_roofline.score: the least time of the ROBE lookup (kernels/csrc/robe_lookup.cu) on each call's own ids over its device time, per cent."""

from lib.readers import roofline
from lib.work import robe_lookup

UNIT = "%"
KERNELS = ("robe_lookup_kernel",)


def work(ctx, i):
    b, f = ctx.pool[i]["sparse"].shape
    return robe_lookup(b, f, ctx.cfg["embed_dim"], ctx.touched(i))


def read(ctx):
    return roofline(ctx, KERNELS, work)
