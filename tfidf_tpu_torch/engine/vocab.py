"""Vocabulary: term string <-> dense integer id (host side).

A copy of ``tfidf_tpu.engine.vocab``: append-only, ids in first-seen
order, device capacity in power-of-two buckets. :class:`NativeVocabulary`
is the same API over the native C++ term table
(:mod:`tfidf_tpu_torch.native`), which the ingest fast path fills.
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

    def save(self, path: str) -> None:
        # a checkpoint file: its manifest CRC and fsync happen when the
        # checkpoint directory is published, so the write skips the fsync
        from tfidf_tpu_torch.utils import storage
        storage.atomic_write_bytes(
            path, "".join(t + "\n" for t in self.all_terms()).encode(),
            fsync=False)

    def load_into(self, path: str) -> None:
        """Append every term from a vocab file, in order (checkpoint
        restore). Works for any backend — terms go through ``add``."""
        with open(path, encoding="utf-8") as f:
            for line in f:
                self.add(line.rstrip("\n"))


class NativeVocabulary(Vocabulary):
    """Vocabulary view over the native C++ term table
    (:class:`tfidf_tpu_torch.native.NativeEngine`): the ingest fast path
    adds terms natively; this adapter keeps the Python API (queries,
    checkpoints) on the same table."""

    def __init__(self, native, min_capacity: int = 1 << 15) -> None:
        super().__init__(min_capacity)
        self._native = native
        # ids of terms already looked up: the table is append-only, so a
        # found id never changes. Query vectorization looks up every term
        # of every query, and one ctypes round trip (lock included) costs
        # ~10x a dict hit; misses always ask the table (the term may be
        # ingested later).
        self._found: dict[str, int] = {}

    def __len__(self) -> int:
        return self._native.vocab_size()

    def add(self, term: str) -> int:
        return self._native.lookup(term, add=True)

    def lookup(self, term: str) -> int | None:
        tid = self._found.get(term)
        if tid is None:
            tid = self._native.lookup(term, add=False)
            if tid is not None:
                self._found[term] = tid
        return tid

    def term(self, tid: int) -> str:
        return self._native.term(tid)

    def all_terms(self) -> list[str]:
        return self._native.dump_terms()
