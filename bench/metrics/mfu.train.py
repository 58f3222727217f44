"""mfu.train: the model's FLOPs of every sample of the traced window (lib/work.py, from the configuration's shapes) over the window's seconds, as a per cent of the card's float32 peak outside the tensor cores."""

from lib.readers import mfu

UNIT = "%"


def read(ctx):
    return mfu(ctx, "train")
