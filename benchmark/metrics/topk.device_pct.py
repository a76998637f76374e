"""``topk.device_pct``: the share of device busy time in the traced window
spent in the kernels of ``aten::topk`` (``ops/topk.py`` ``exact_topk``,
``_keyed_topk``): its radix select (the ``mbtopk`` and ``sbtopk``
kernels, ``gatherTopK``) and the in-place sort of its k winners. The
elementwise kernels that build the keys are not among them."""

KERNELS = r"topk::|TopK|SortKVInPlace|sortKeyValueInplace"


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or tr.busy_s <= 0:
        return None
    t = tr.device_time(KERNELS)
    return 100.0 * t / tr.busy_s if t > 0 else None
