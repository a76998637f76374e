"""``segments.merges``: segment merges the window spliced in (the merge
policy of ``engine/segments.py``, inline and on the merge threads): the
window's delta of ``merges_background`` plus ``merges_inline``."""

KEYS = ("merges_background", "merges_inline")


def read(ctx):
    c0, c1 = ctx["counters"]
    return float(sum(c1.get(k, 0) - c0.get(k, 0) for k in KEYS))
