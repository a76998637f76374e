"""``search.roofline_pct``: all device busy time in the traced window
against the least work the window's batches need, whatever implements
them (``engine/searcher.py`` through ``ops/ell.py`` and ``ops/topk.py``).

Per batch, the larger of (1) bytes: the postings of the batch's distinct
query terms (a document id and an impact, 8 bytes each) read once, and
the top-k (a score and an id, 8 bytes each) written once, at the card's
bandwidth; (2) one multiply-add per (query, posting of a term it holds),
at the card's float32 rate. Counted from the corpus and the queries, so a
fused or term-at-a-time design leaves it meaningful.
"""

import numpy as np

from harness.stats import least_seconds


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or tr.busy_s <= 0 or not ctx.get("runs") \
            or "pool" not in ctx:
        return None
    df = ctx["df"].astype(np.float64)
    B, k = ctx["batch"], ctx["k"]
    per_batch = []
    for qs in ctx["pool"]:
        uniq = np.unique(np.concatenate(qs)) if qs else np.zeros(0, int)
        ma = float(sum(df[q].sum() for q in qs))
        per_batch.append(least_seconds(8 * df[uniq].sum() + 8 * B * k, ma))
    return 100.0 * sum(per_batch[p] for p in ctx["runs"]) / tr.busy_s
