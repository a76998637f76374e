"""Vocabulary: term string <-> dense integer id (host side).

A copy of ``tfidf_tpu.engine.vocab.Vocabulary``: append-only, ids in
first-seen order, device capacity in power-of-two buckets. The native C++
term table (``NativeVocabulary``) is not ported yet; the JAX package
treats the Python chain as result-identical to it.
"""

from __future__ import annotations

from typing import Iterable

from tfidf_tpu_torch.ops.csr import next_capacity


class Vocabulary:
    def __init__(self, min_capacity: int = 1 << 15) -> None:
        self._ids: dict[str, int] = {}
        self._terms: list[str] = []
        self._min_capacity = min_capacity

    def __len__(self) -> int:
        return len(self._terms)

    def capacity(self) -> int:
        """Current power-of-two device capacity bucket (>= len + 1)."""
        return next_capacity(len(self) + 1, self._min_capacity)

    def add(self, term: str) -> int:
        tid = self._ids.get(term)
        if tid is None:
            tid = len(self._terms)
            self._ids[term] = tid
            self._terms.append(term)
        return tid

    def extend(self, terms: Iterable[str]) -> None:
        """Append terms in order — copying another vocabulary's term list
        (``all_terms()``) reproduces its ids exactly, which is what serving
        an index built elsewhere (``ShardIndex.install_snapshot_arrays``)
        needs."""
        for t in terms:
            self.add(t)

    def lookup(self, term: str) -> int | None:
        return self._ids.get(term)

    def term(self, tid: int) -> str:
        return self._terms[tid]

    def all_terms(self) -> list[str]:
        """Every term in id order."""
        return self._terms

    def map_counts(self, counts: dict[str, int], *,
                   add: bool) -> dict[int, int]:
        """Map a term->freq dict to id->freq. With ``add=False`` (query
        side), unknown terms are dropped."""
        out: dict[int, int] = {}
        for term, c in counts.items():
            tid = self.add(term) if add else self.lookup(term)
            if tid is not None:
                out[tid] = out.get(tid, 0) + c
        return out
