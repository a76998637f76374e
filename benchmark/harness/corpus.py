"""Traffic and corpus draws from ``--seed``, on the device.

Frozen rewrites of the program's numpy draws (``make_doc_arrays``,
``make_texts``, ``make_queries`` of the root ``bench.py``) with the same
distributions, drawn with a ``torch.Generator`` on the card in a few large
calls: terms Zipf(a) taken mod the vocabulary, document lengths Poisson
clipped below, queries of a uniform number of Zipf terms. The same seed
and device give the same draws.

A term id ``i`` is the token ``t<i>``; that is the text form both the
system and the reference are handed.
"""

from __future__ import annotations

import numpy as np
import torch

# numpy's zipf rejects draws past the int64 range; so does this one
_ZIPF_MAX = float(2 ** 62)


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (2 ** 63))
    return g


def zipf(g: torch.Generator, n: int, a: float, device) -> torch.Tensor:
    """``n`` draws of Zipf(``a``) as int64, by numpy's rejection method
    (Devroye), vectorized: propose in bulk, keep the accepted in order."""
    am1 = a - 1.0
    b = 2.0 ** am1
    out = []
    have = 0
    while have < n:
        m = int((n - have) * 1.25) + 1024
        u = 1.0 - torch.rand(m, generator=g, device=device,
                             dtype=torch.float64)
        v = torch.rand(m, generator=g, device=device, dtype=torch.float64)
        x = torch.floor(u.pow(-1.0 / am1))
        ok = (x >= 1.0) & (x < _ZIPF_MAX)
        t = (1.0 + 1.0 / x).pow(am1)
        ok &= v * x * (t - 1.0) / (b - 1.0) <= t / b
        x = x[ok][:n - have]
        out.append(x.to(torch.int64))
        have += x.shape[0]
    return torch.cat(out)


def lengths(g: torch.Generator, n: int, mean: float, floor: int,
            device) -> torch.Tensor:
    rate = torch.full((n,), float(mean), device=device, dtype=torch.float32)
    return torch.poisson(rate, generator=g).to(torch.int64).clamp_(min=floor)


def doc_arrays(g: torch.Generator, n_docs: int, vocab: int, mean_len: float,
               min_len: int, zipf_a: float, device) -> tuple:
    """A Zipfian corpus as host numpy ``(offsets [n+1] i64, ids [nnz] i32,
    tfs [nnz] f32, lengths [n] f32)``: doc ``i`` owns the sorted distinct
    term ids ``ids[offsets[i]:offsets[i+1]]`` with their counts, and its
    length is its number of tokens."""
    lens = lengths(g, n_docs, mean_len, min_len, device)
    total = int(lens.sum())
    terms = zipf(g, total, zipf_a, device) % vocab
    doc_of = torch.repeat_interleave(
        torch.arange(n_docs, device=device), lens)
    key, counts = torch.unique(doc_of * vocab + terms, sorted=True,
                               return_counts=True)
    del doc_of, terms
    ud = key // vocab
    offsets = torch.searchsorted(ud, torch.arange(n_docs + 1, device=device))
    return (offsets.cpu().numpy(), (key % vocab).to(torch.int32).cpu().numpy(),
            counts.to(torch.float32).cpu().numpy(),
            lens.to(torch.float32).cpu().numpy())


def token_seqs(g: torch.Generator, n: int, vocab: int, mean_len: float,
               min_len: int, zipf_a: float, device) -> tuple:
    """``n`` token sequences (passages to upload as text): host
    ``(offsets [n+1], term ids [total])`` in token order."""
    lens = lengths(g, n, mean_len, min_len, device)
    terms = zipf(g, int(lens.sum()), zipf_a, device) % vocab
    offsets = torch.cat([torch.zeros(1, dtype=torch.int64, device=device),
                         torch.cumsum(lens, 0)])
    return offsets.cpu().numpy(), terms.cpu().numpy()


def query_terms(g: torch.Generator, n: int, vocab: int, t_min: int,
                t_max: int, zipf_a: float, device) -> tuple:
    """``n`` queries of a uniform ``t_min``..``t_max`` number of Zipf
    terms: host ``(offsets [n+1], term ids)``."""
    lens = torch.randint(t_min, t_max + 1, (n,), generator=g, device=device)
    terms = zipf(g, int(lens.sum()), zipf_a, device) % vocab
    offsets = torch.cat([torch.zeros(1, dtype=torch.int64, device=device),
                         torch.cumsum(lens, 0)])
    return offsets.cpu().numpy(), terms.cpu().numpy()


class Tokens:
    """The text form of term ids: ``t<i>``."""

    def __init__(self, vocab: int) -> None:
        self.table = np.asarray([f"t{i}" for i in range(vocab)], object)

    def texts(self, offsets: np.ndarray, ids: np.ndarray) -> list[str]:
        words = self.table[ids].tolist()
        off = offsets.tolist()
        return [" ".join(words[off[i]:off[i + 1]])
                for i in range(len(off) - 1)]


def remap_present(ids: np.ndarray, vocab: int) -> tuple:
    """(ids renumbered to their rank among the terms the corpus holds,
    those terms in rank order): the vocabulary an index built from this
    corpus has, in the order a restore hands it back."""
    present = np.flatnonzero(np.bincount(ids, minlength=vocab))
    rank = np.full(vocab, -1, np.int64)
    rank[present] = np.arange(present.shape[0])
    return rank[ids].astype(np.int32), present
