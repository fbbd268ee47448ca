"""``device_idle_share.train``: the share of the traced window in which
no operation (kernel, copy or fill) ran on the card, in %."""


def read(ctx):
    if ctx.busy_s <= 0 or ctx.window_s <= 0:
        return None
    return 100.0 * max(0.0, 1.0 - ctx.busy_s / ctx.window_s)
