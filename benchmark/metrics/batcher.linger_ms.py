"""``batcher.linger_ms``: the mean wait of a query in the coalescer before
its batch is dispatched, over the window's ``query_linger``
observations."""


def read(ctx):
    c0, c1 = ctx["counters"]
    n = c1.get("query_linger_count", 0) - c0.get("query_linger_count", 0)
    s = c1.get("query_linger_sum_ms", 0.0) - c0.get("query_linger_sum_ms",
                                                    0.0)
    return s / n if n > 0 else None
