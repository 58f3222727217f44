"""robe_lookup_bwd_roofline.train: the least time of the ROBE lookup's backward (kernels/csrc/robe_lookup_bwd.cu: its bucketing passes and scatter, not the zeroing of the gradient) on each step's own ids over its device time, per cent."""

from lib.readers import roofline
from lib.work import robe_lookup_bwd

UNIT = "%"
KERNELS = ("rb_count_kernel", "rb_scan_kernel", "rb_place_kernel",
           "rb_scatter_kernel")


def work(ctx, i):
    b, f = ctx.pool[i]["sparse"].shape
    return robe_lookup_bwd(b, f, ctx.cfg["embed_dim"], ctx.touched(i))


def read(ctx):
    return roofline(ctx, KERNELS, work)
