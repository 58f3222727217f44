"""step_host_ms.train: host milliseconds to enqueue one training step inside the program (its span `train.step`, the whole of `step_fn`: forward, backward, the NaN guard and the update, with no wait for the card), the mean over the traced window's steps."""

from lib.spans import root_ms

UNIT = "ms"


def read(ctx):
    return root_ms(ctx, "train.step")
