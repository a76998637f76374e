"""The benchmark's CPU tests: the harness and the reference at test sizes.

    python -m pytest benchmark/tests -q
"""

import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
for p in (ROOT, BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)

import pytest  # noqa: E402

# a cell at a size a test run holds: the same code paths, smaller data
TINY = {"config": {"docs": 3000, "vocab": 4000},
        "traffic": {"pool_batches": 4, "batch": 64, "pool_requests": 4,
                    "request": 100},
        "workload": {"query_rate": 40, "check": 48, "read_back": 6}}


@pytest.fixture
def tiny():
    return {k: dict(v) for k, v in TINY.items()}


def with_stream_cell() -> dict:
    """``BENCHMARK.json`` with the streaming cell's entries added: the cell
    is out of the benchmark until its rates are found again (PERF.md), and
    its loop, readers and check stay under test."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        m = json.load(f)
    with open(os.path.join(HERE, "stream_cell.json")) as f:
        extra = json.load(f)
    for k, v in extra.items():
        m[k] = m[k] + v
    return m


@pytest.fixture(scope="session")
def manifest(tmp_path_factory):
    path = tmp_path_factory.mktemp("manifest") / "BENCHMARK.json"
    path.write_text(json.dumps(with_stream_cell()))
    return str(path)
