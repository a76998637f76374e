"""The plain reference: BM25 top-k over a collection, in NumPy and SciPy.

It shares no code with the system under test and takes nothing the system
made. The benchmark hands it what it handed the system: the documents as
packed term-id arrays (term ``i`` is the token ``t<i>``) or as text, the
queries as text, and the order of the uploads, deletes and commits. From
these it works out everything again: tokens and their counts, the
vocabulary, df, N and avgdl, the live set, every score in float64, and
the top-k in (-score, row) order.

Scoring is Lucene 9's ``BM25Similarity`` (k1 1.2, b 0.75) with exact
document lengths: ``idf(t) = ln(1 + (N - df + 0.5) / (df + 0.5))`` and a
posting's impact ``idf * tf / (tf + k1 * (1 - b + b * dl / avgdl))``; a
query term repeated counts that many times.

:func:`tf32` rounds float32 to TensorFloat-32 (10 mantissa bits, round to
nearest even). The control of ``correct`` is this reference computed with
its impacts and query weights in TF32 and summed in float32 (what a
tensor-core product would do), put in the system's place.
"""

from __future__ import annotations

import re

import numpy as np
import scipy.sparse as sp

K1 = 1.2
B = 0.75

# Lucene's StandardAnalyzer on the benchmark's text: runs of digits (with
# inner separators) or word characters (with inner apostrophes), lowercased
_TOKEN = re.compile(r"\d+(?:[.,]\d+)*|\w+(?:['’]\w+)*", re.UNICODE)


def tokenize(text: str) -> list[str]:
    return [m.group(0).lower() for m in _TOKEN.finditer(text)]


class Vocabulary:
    """Token -> reference id; the packed arrays' term ``i`` is ``t<i>``,
    and tokens seen later get the next ids."""

    def __init__(self, n_packed: int) -> None:
        self.ids = {f"t{i}": i for i in range(n_packed)}

    def counts(self, text: str, add: bool) -> tuple[np.ndarray, np.ndarray,
                                                    float]:
        """(sorted term ids, counts, length in tokens) of ``text``; with
        ``add`` False unknown tokens are dropped (the query side)."""
        toks = tokenize(text)
        ids = []
        for t in toks:
            i = self.ids.get(t)
            if i is None:
                if not add:
                    continue
                i = self.ids[t] = len(self.ids)
            ids.append(i)
        u, c = np.unique(np.asarray(ids, np.int64), return_counts=True)
        return u, c.astype(np.float64), float(len(toks))

    def __len__(self) -> int:
        return len(self.ids)


class Rows:
    """Document versions as rows of a CSR matrix of term counts: the
    packed corpus first, then one row per uploaded text."""

    def __init__(self, offsets, ids, tfs, lengths) -> None:
        self._parts = [(np.asarray(offsets, np.int64),
                        np.asarray(ids, np.int64),
                        np.asarray(tfs, np.float64),
                        np.asarray(lengths, np.float64))]
        self._n = len(offsets) - 1
        self._extra: list = []
        self.csr = None

    def append(self, ids: np.ndarray, tfs: np.ndarray, length: float) -> int:
        self._extra.append((ids, tfs, length))
        self._n += 1
        return self._n - 1

    def __len__(self) -> int:
        return self._n

    def freeze(self, n_terms: int) -> None:
        """Build the row-major and term-major matrices of every row."""
        off, ids, tfs, lengths = self._parts[0]
        if self._extra:
            e_len = np.asarray([len(e[0]) for e in self._extra], np.int64)
            off = np.concatenate([off, off[-1] + np.cumsum(e_len)])
            ids = np.concatenate([ids] + [e[0] for e in self._extra])
            tfs = np.concatenate([tfs] + [e[1] for e in self._extra])
            lengths = np.concatenate(
                [lengths, np.asarray([e[2] for e in self._extra])])
        self.lengths = lengths
        self.csr = sp.csr_matrix((tfs, ids, off), shape=(self._n, n_terms))
        self.csc = self.csr.tocsc()
        self.csc.sort_indices()

    def df_range(self, a: int, b: int) -> np.ndarray:
        """Documents per term over rows ``a`` .. ``b - 1``."""
        ip = self.csr.indptr
        return np.bincount(self.csr.indices[ip[a]:ip[b]],
                           minlength=self.csr.shape[1]).astype(np.float64)

    def df(self, rows: np.ndarray | None = None) -> np.ndarray:
        """Documents per term over ``rows`` (a row-index array; None:
        every row)."""
        idx = self.csr.indices if rows is None else self.csr[rows].indices
        return np.bincount(idx, minlength=self.csr.shape[1]
                           ).astype(np.float64)

    def total_len(self, rows: np.ndarray | None = None) -> float:
        return float(self.lengths.sum() if rows is None
                     else self.lengths[rows].sum())


class Stats:
    """Collection statistics: df per term, N and the summed length."""

    def __init__(self, df: np.ndarray, n: float, total_len: float) -> None:
        self.df, self.n, self.total_len = df, float(n), float(total_len)
        self._norm = None

    def norm(self, rows: Rows) -> np.ndarray:
        """Per row: ``k1 * (1 - b + b * dl / avgdl)``."""
        if self._norm is None:
            self._norm = K1 * (1.0 - B + B * rows.lengths / self.avgdl)
        return self._norm

    @property
    def avgdl(self) -> float:
        return self.total_len / self.n if self.n else 1.0

    def idf(self, terms: np.ndarray) -> np.ndarray:
        d = self.df[terms]
        return np.log1p((self.n - d + 0.5) / (d + 0.5))


def query_terms(vocab: Vocabulary, text: str) -> tuple[np.ndarray,
                                                       np.ndarray]:
    ids, counts, _ = vocab.counts(text, add=False)
    return ids, counts


def scores(rows: Rows, stats: Stats, terms: np.ndarray, weights:
           np.ndarray, live: np.ndarray | None, precision: str = "f64"
           ) -> np.ndarray:
    """Every row's score for one query (0 where a row is not ``live``, a
    bool mask; None: every row is): the sum over the query's terms of
    weight x impact. ``precision`` "f64" is the reference; "tf32" rounds
    impacts and weights to TF32 and sums in float32 (the control)."""
    csc = rows.csc
    idf = stats.idf(terms)
    norm = stats.norm(rows)
    dtype = np.float32 if precision == "tf32" else np.float64
    acc = np.zeros(len(rows), dtype)
    for t, w, f in zip(terms.tolist(), weights.tolist(), idf.tolist()):
        lo, hi = csc.indptr[t], csc.indptr[t + 1]
        r = csc.indices[lo:hi]
        tf = csc.data[lo:hi]
        imp = f * tf / (tf + norm[r])
        if precision == "tf32":
            acc[r] += tf32(imp.astype(np.float32)) * tf32(np.float32(w))
        else:
            acc[r] += imp * w    # a term's rows are distinct
    if live is not None:
        acc[~live] = 0
    return acc


def top_k(acc: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """The first ``k`` positive scores in (-score, row) order: (rows,
    scores)."""
    hit = np.flatnonzero(acc > 0)
    val = acc[hit]
    if hit.shape[0] > k:
        kth = -np.partition(-val, k - 1)[k - 1]
        keep = val >= kth
        hit, val = hit[keep], val[keep]
    order = np.lexsort((hit, -val))[:k]
    return hit[order], val[order].astype(np.float64)


def tf32(x: np.ndarray) -> np.ndarray:
    """float32 rounded to TensorFloat-32 (nearest, ties to even)."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    u = (u + np.uint32(0x0FFF) + ((u >> np.uint32(13)) & np.uint32(1))) \
        & np.uint32(0xFFFFE000)
    return u.view(np.float32)
