"""``ingest.request_ms``: the median, over the window's upload requests,
of the harness's clock around one request (``Engine.ingest_text`` and
``Engine.delete`` through ``ops/analyzer.py`` and ``native/``)."""

from harness.stats import median


def read(ctx):
    ms = ctx.get("clocks", {}).get("request_ms")
    return median(ms) if ms else None
