"""The plain reference against hand-worked cases, and the system against
the reference on each cell's path at a test size on the CPU."""

import json
import math

import numpy as np
import pytest

from harness import cell
from reference import bm25

# three documents over terms t0..t3: term counts per document
DOCS = [{0: 2, 1: 1}, {1: 1, 2: 3}, {0: 1, 3: 1}]


def _rows():
    off, ids, tfs, lens = [0], [], [], []
    for d in DOCS:
        for t in sorted(d):
            ids.append(t)
            tfs.append(d[t])
        off.append(len(ids))
        lens.append(sum(d.values()))
    rows = bm25.Rows(np.array(off), np.array(ids), np.array(tfs, float),
                     np.array(lens, float))
    rows.freeze(4)
    return rows


def test_bm25_by_hand():
    rows = _rows()
    st = bm25.Stats(rows.df(), len(rows), rows.total_len())
    assert st.n == 3 and st.avgdl == pytest.approx(3.0)
    vocab = bm25.Vocabulary(4)
    terms, w = bm25.query_terms(vocab, "T0 t2 t0 unknown")
    np.testing.assert_array_equal(terms, [0, 2])
    np.testing.assert_array_equal(w, [2.0, 1.0])
    acc = bm25.scores(rows, st, terms, w, None)

    def imp(tf, df, dl):
        idf = math.log(1 + (3 - df + 0.5) / (df + 0.5))
        return idf * tf / (tf + 1.2 * (1 - 0.75 + 0.75 * dl / 3))

    want = [2 * imp(2, 2, 3), imp(3, 1, 4), 2 * imp(1, 2, 2)]
    np.testing.assert_allclose(acc, want, rtol=1e-12)
    live = np.array([True, False, True])
    assert bm25.scores(rows, st, terms, w, live)[1] == 0.0


def test_top_k_orders_by_score_then_lower_row():
    acc = np.array([0.5, 2.0, 0.0, 2.0, 1.0, 2.0])
    r, v = bm25.top_k(acc, 4)
    np.testing.assert_array_equal(r, [1, 3, 5, 4])
    np.testing.assert_array_equal(v, [2.0, 2.0, 2.0, 1.0])
    r, _ = bm25.top_k(acc, 10)
    np.testing.assert_array_equal(r, [1, 3, 5, 4, 0])


def test_tokens_as_the_analyzer_cuts_them():
    assert bm25.tokenize("Fast, fast-food 3.14 don't") == \
        ["fast", "fast", "food", "3.14", "don't"]


def test_tf32_keeps_ten_mantissa_bits():
    x = np.array([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11,
                  1.0 + 2 ** -12], np.float32)
    np.testing.assert_array_equal(
        bm25.tf32(x), np.array([1.0, 1.0 + 2 ** -10, 1.0, 1.0 + 2 ** -9,
                                1.0], np.float32))


@pytest.mark.parametrize("workload", ["wiki1m.b512", "msmarco_shard.stream",
                                      "wiki1m.long"])
def test_the_system_agrees_with_the_reference(workload, tiny, manifest,
                                             capsys):
    rc = cell.run(["--workload", workload, "--seed", "2147483659",
                   "--seconds", "1.5", "--trace", "0"], device="cpu",
                  overrides=tiny, manifest=manifest)
    assert rc == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] is True, line["compared"]
    assert line["attempted"] > 0 and line["failed"] == 0
    for v in line["compared"].values():
        assert v["value"] <= v["limit"]
