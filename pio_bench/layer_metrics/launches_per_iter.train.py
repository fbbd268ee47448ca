"""``launches_per_iter.train``: device kernels the trainer launches per
ALS iteration, counted in the traced window (copies and fills left out),
over the iterations of the traced trains."""


def read(ctx):
    launches = len(ctx.kernels())
    if not launches or not ctx.iterations:
        return None
    return launches / ctx.iterations
