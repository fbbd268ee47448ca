"""``gram_padding_share``: the share of the Gram's work spent on padding,
in %: the ``padding`` entries over the ``entries`` the Gram looped over,
summed across the program's ``als.gram`` spans of the traced window.
The layout pads each side to a geometric bucket of whole chunks, and
the Gram runs over every chunk, padding included."""

from pio_bench import spans


def read(ctx):
    grams = spans.gram_spans()
    if grams is None:
        return None
    entries = sum(s.attrs["entries"] for s in grams)
    if entries <= 0:
        return None
    return 100.0 * sum(s.attrs["padding"] for s in grams) / entries
