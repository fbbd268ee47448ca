"""``gram_roofline``: the Gram's least time over its device time, in %.

The least time is ``roofline/gram.py``'s, per half-step (users from the
item factors, items from the user factors), summed over the traced
iterations. The device time is every kernel of the traced window except
kernel A's: the Gram, the right-hand side, the ridge and the copies that
feed kernel A are all the trainer's work around the solve."""

from pio_bench.roofline import gram, solve


def read(ctx):
    cfg, peaks = ctx.config, ctx.peaks
    spent = sum((op.end_ns - op.start_ns) / 1e9 for op in ctx.kernels()
                if solve.KERNEL not in op.name)
    if not peaks or spent <= 0 or not ctx.iterations:
        return None
    n, r = int(cfg["n_ratings"]), int(cfg["rank"])
    users, items = int(cfg["n_users"]), int(cfg["n_items"])
    least = ctx.iterations * (gram.least_s(n, users, items, r, peaks)
                              + gram.least_s(n, items, users, r, peaks))
    return 100.0 * least / spent
