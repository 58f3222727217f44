"""serve_fused_roofline.score: the least time of the fused ROBE lookup, pooling and gram (kernels/csrc/serve_fused.cu) on each call's own ids over its device time, per cent."""

from lib.readers import roofline
from lib.work import serve_fused

UNIT = "%"
KERNELS = ("serve_fused_kernel",)


def work(ctx, i):
    b, f = ctx.pool[i]["sparse"].shape
    return serve_fused(b, f, ctx.cfg["embed_dim"], ctx.touched(i))


def read(ctx):
    return roofline(ctx, KERNELS, work)
