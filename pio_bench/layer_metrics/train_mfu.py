"""``train_mfu``: the trainer loop's share of the card's fp32 peak, in %:
the fp32 operations the traced iterations need (the Gram of both
half-steps and kernel A's solves, counted from the shapes by
``roofline/``), over the traced window's length times the peak. It
bounds the kernels' rooflines from above, so a change that takes a
kernel off the path, and silences its roofline, is still read here."""

from pio_bench.roofline import gram, solve


def read(ctx):
    cfg, peaks = ctx.config, ctx.peaks
    if not peaks or ctx.window_s <= 0 or not ctx.iterations \
            or not ctx.kernels():
        return None
    n, r = int(cfg["n_ratings"]), int(cfg["rank"])
    per_iteration = (2 * gram.operations(n, r)
                     + solve.operations(int(cfg["n_users"]), r)
                     + solve.operations(int(cfg["n_items"]), r))
    return 100.0 * ctx.iterations * per_iteration / (
        ctx.window_s * peaks["fp32_flops_s"])
