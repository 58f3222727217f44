"""dot_interaction_bwd_roofline.train: the least time of the interaction's backward (kernels/csrc/dot_interaction_bwd.cu) over its device time, per cent."""

from lib.readers import roofline
from lib.work import dot_interaction_bwd

UNIT = "%"
KERNELS = ("dot_interaction_bwd_kernel",)


def work(ctx, i):
    b, f = ctx.pool[i]["sparse"].shape
    return dot_interaction_bwd(b, f + 1, ctx.cfg["embed_dim"])


def read(ctx):
    return roofline(ctx, KERNELS, work)
