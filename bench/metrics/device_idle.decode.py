"""device_idle.decode: per cent of the traced window in which no kernel, copy or fill ran on the card."""

from lib.readers import idle_share

UNIT = "%"


def read(ctx):
    return idle_share(ctx)
