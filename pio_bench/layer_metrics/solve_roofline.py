"""``solve_roofline``: kernel A's least time over its device time, in %.

The least time is ``roofline/solve.py``'s for the users' and the items'
systems of each traced iteration; the device time is that of the kernels
named ``gj_solve`` in the traced window."""

from pio_bench.roofline import solve


def read(ctx):
    cfg, peaks = ctx.config, ctx.peaks
    spent = sum((op.end_ns - op.start_ns) / 1e9 for op in ctx.kernels()
                if solve.KERNEL in op.name)
    if not peaks or spent <= 0 or not ctx.iterations:
        return None
    r = int(cfg["rank"])
    least = ctx.iterations * (solve.least_s(int(cfg["n_users"]), r, peaks)
                              + solve.least_s(int(cfg["n_items"]), r, peaks))
    return 100.0 * least / spent
