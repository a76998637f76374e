"""BM25 — the reference system's true scoring function.

Lucene 9's default similarity is ``BM25Similarity`` (k1=1.2, b=0.75); the
reference never overrides it, so every worker scores BM25 against its local
shard (``Worker.java:222-241``). Two fidelity levels:

* exact BM25 with true document lengths (default — strictly better);
* ``lucene_parity=True`` additionally reproduces Lucene's lossy 1-byte norm
  encoding (``SmallFloat.intToByte4``): document lengths round-trip through
  a 4-mantissa-bit byte code before entering the length normalization, which
  is required for score-identical parity with the Java system.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from tfidf_tpu_torch.models.base import ScoringModel


# --- SmallFloat byte-4 codec (org.apache.lucene.util.SmallFloat) ----------

def _long_to_int4(i: int) -> int:
    if i < 0:
        raise ValueError("negative length")
    num_bits = i.bit_length()
    if num_bits < 4:
        return i
    shift = num_bits - 4
    encoded = (i >> shift) & 0x07      # drop the implicit leading 1 bit
    encoded |= (shift + 1) << 3
    return encoded


def _int4_to_long(i: int) -> int:
    bits = i & 0x07
    shift = (i >> 3) - 1
    return bits if shift == -1 else (bits | 0x08) << shift


_MAX_INT4 = _long_to_int4(2**31 - 1)
_NUM_FREE_VALUES = 255 - _MAX_INT4


def int_to_byte4(i: int) -> int:
    """Lossy int -> unsigned byte with 4 mantissa bits (values 0..39 exact)."""
    if i < _NUM_FREE_VALUES:
        return i
    return _NUM_FREE_VALUES + _long_to_int4(i - _NUM_FREE_VALUES)


def byte4_to_int(b: int) -> int:
    if b < _NUM_FREE_VALUES:
        return b
    return _NUM_FREE_VALUES + _int4_to_long(b - _NUM_FREE_VALUES)


def quantize_length(dl: int) -> int:
    """Length as BM25 sees it after Lucene's norm round-trip."""
    return byte4_to_int(int_to_byte4(int(dl)))


_QUANT_TABLE = None


def _quant_table() -> np.ndarray:
    global _QUANT_TABLE
    if _QUANT_TABLE is None:
        # decode table over all 256 byte codes; encode via searchsorted
        _QUANT_TABLE = np.array([byte4_to_int(b) for b in range(256)],
                                dtype=np.int64)
    return _QUANT_TABLE


def quantize_lengths(dl: np.ndarray) -> np.ndarray:
    """Vectorized quantize_length over an int array."""
    table = _quant_table()
    # codes are monotonically increasing in dl; find the largest decoded
    # value <= encode(dl) by emulating encode: encode is monotone, and
    # round-trip maps dl to the table entry at its encoded byte.
    codes = np.searchsorted(table, dl, side="right") - 1
    return table[np.clip(codes, 0, 255)]


@dataclass(frozen=True)
class BM25Model(ScoringModel):
    kind: str = "bm25"
    k1: float = 1.2
    b: float = 0.75
    lucene_parity: bool = False

    def score_kwargs(self) -> dict:
        return {"model": "bm25", "k1": self.k1, "b": self.b}

    def transform_doc_len(self, doc_len: np.ndarray) -> np.ndarray:
        if not self.lucene_parity:
            return doc_len
        out = quantize_lengths(doc_len.astype(np.int64))
        return out.astype(np.float32)
