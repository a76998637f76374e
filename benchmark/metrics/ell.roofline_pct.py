"""``ell.roofline_pct``: the ELL kernel (``ops/ell.py`` ``score_ell_batch``,
``csrc/ell_score.cu``) against its least time, in the traced window.

Device time: every device operation named like :data:`KERNEL`. Least time,
per batch, the larger of (1) bytes: each launched block's postings
(impact and term, 8 bytes a slot of its width) and its scores (4 bytes a
query and row) once, the batch's ``slot_of`` (4 bytes a vocabulary slot)
and query weights (4 bytes a distinct term and query) once, at the
card's bandwidth; (2) one multiply-add per (query, posting of a term it
holds) in the launched blocks, at the card's float32 rate. Blocks launch
where the kernel's envelope takes them (:func:`eligible`, a frozen copy of
the program's rule); the reader returns nothing unless the window's
launch count is the window's batches times those blocks.
"""

import numpy as np

from harness.stats import least_seconds

KERNEL = r"ell_score_kernel"
COUNTER = "ell_kernel_launches_v4"


def eligible(rows_cap: int, batch: int, u_cap: int) -> bool:
    return (rows_cap % 256 == 0 and rows_cap >= 256 and batch <= 2048
            and u_cap % 256 == 0)


def read(ctx):
    tr, ell = ctx.get("trace"), ctx.get("ell")
    if tr is None or not ell or not ctx.get("runs"):
        return None
    t = tr.device_time(KERNEL)
    if t <= 0:
        return None
    B = ctx["batch"]
    blocks = ell["blocks"]
    on = [i for i, b in enumerate(blocks)
          if eligible(b["rows_cap"], B, ell["u_cap"])]
    c0, c1 = ctx["counters"]
    if c1.get(COUNTER, 0) - c0.get(COUNTER, 0) != len(ctx["runs"]) * len(on):
        return None
    df = sum(ell["df"][i].astype(np.float64) for i in on)
    fixed = sum(8 * blocks[i]["width"] * blocks[i]["rows"]
                + 4 * B * blocks[i]["rows"] for i in on) + 4 * ell["vocab_cap"]
    per_batch = []
    for qs in ctx["pool"]:
        uniq = np.unique(np.concatenate(qs)) if qs else np.zeros(0, int)
        ma = float(sum(df[q].sum() for q in qs))
        per_batch.append(least_seconds(fixed + 4 * (uniq.size + 1) * B, ma))
    bound = sum(per_batch[p] for p in ctx["runs"])
    return 100.0 * bound / t
