"""``batcher.items_per_batch``: queries per device batch the worker's
coalescer (``cluster/batcher.py`` ``QueryBatcher``) formed in the window:
the window's deltas of its ``query_items`` and ``query_batches``
counters."""


def read(ctx):
    c0, c1 = ctx["counters"]
    batches = c1.get("query_batches", 0) - c0.get("query_batches", 0)
    items = c1.get("query_items", 0) - c0.get("query_items", 0)
    return items / batches if batches > 0 else None
