"""``segments.commit_ms``: the median, over the window's refreshes, of the
harness's clock around ``Engine.commit()`` (``engine/segments.py``
``SegmentedIndex.commit``), closed by a synchronize of the stream."""

from harness.stats import median


def read(ctx):
    ms = ctx.get("clocks", {}).get("commit_ms")
    return median(ms) if ms else None
