"""``idle_in_gram_share.train``: the card's idle time while the trainer's
host thread was inside an ``als.gram`` span, over the traced window, in
%: the union of the spans less the union of the device operations'
intervals within it. It is the part of ``device_idle_share.train`` that
falls while the host runs the Gram's chunk loop."""

from pio_bench import spans, trace


def read(ctx):
    grams = spans.gram_spans()
    if grams is None or ctx.window_s <= 0:
        return None
    inside = trace.busy_intervals(grams)
    idle = sum(hi - lo for lo, hi in inside) - spans.overlap_ns(
        inside, trace.busy_intervals(ctx.ops))
    return 100.0 * idle / 1e9 / ctx.window_s
