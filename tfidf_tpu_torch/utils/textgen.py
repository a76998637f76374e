"""Offline realistic-text corpus generator (VERDICT r3 #3).

Every earlier bench corpus was synthetic ``t{i}`` integer tokens, which
bypasses the analyzer's real work (Unicode rules, punctuation, the
native ASCII fast path / Python fallback boundary, the extractors). The
reference's workload is real text files run through Lucene's
``StandardAnalyzer`` + Tika (``Worker.java:190-220``). This module
builds a realistic corpus **without network egress**:

* **Lexicon**: real English words harvested from text already in the
  image (Python stdlib sources' docstrings/comments and
  ``/usr/share/doc``), frequency-ranked so a Zipf draw over ranks
  reproduces natural-language token statistics over *actual word
  forms*.
* **Documents**: sentence-cased word sequences with commas/periods,
  apostrophe forms (``word's``, ``don't``-style contractions), numeric
  tokens, paragraph breaks; a configurable fraction are HTML-wrapped,
  Latin-1-encoded (non-UTF-8 charset-fallback path), or binary garbage
  that the ingest contract must refuse with ``UnsupportedMediaType``
  (the 415 path, ``ops/analyzer.py``).
"""

from __future__ import annotations

import collections
import glob
import os
import re
import sysconfig

import numpy as np

_WORD_RE = re.compile(rb"[a-z][a-z]{1,13}")

# fallback seed vocabulary if the image has no harvestable text at all
_SEED = ("the of and to in a is that for it as was with be by on not he "
         "this are or his from at which but have an had they you were "
         "her all she there would their we him been has when who will "
         "more no if out so said what up its about into than them can "
         "only other new some could time these two may then do first "
         "any my now such like our over man me even most made after "
         "also did many before must through years where much your way "
         "well down should because each just those people how too "
         "little state good very make world still own see men work "
         "long get here between both life being under never day same "
         "another know while last might us great old year off come "
         "since against go came right used take three").split()


def harvest_lexicon(max_words: int = 30_000,
                    max_bytes: int = 64 << 20) -> tuple[list[str],
                                                        np.ndarray]:
    """Frequency-ranked English lexicon from text already on disk.

    Returns ``(words, counts)`` sorted by descending frequency. Sources:
    Python stdlib ``.py`` files (docstrings + comments are mostly
    English prose) and ``/usr/share/doc`` README/changelog text.
    Deterministic for a fixed filesystem."""
    counter: collections.Counter[bytes] = collections.Counter()
    budget = max_bytes
    sources: list[str] = []
    stdlib = sysconfig.get_paths().get("stdlib")
    if stdlib and os.path.isdir(stdlib):
        sources.extend(sorted(glob.glob(os.path.join(stdlib, "*.py"))))
        sources.extend(sorted(glob.glob(
            os.path.join(stdlib, "*", "*.py")))[:500])
    for root in ("/usr/share/doc",):
        if os.path.isdir(root):
            for dirpath, _dirs, files in sorted(os.walk(root)):
                for f in sorted(files):
                    if f.endswith((".txt", ".md", "README", "copyright",
                                   "README.Debian")):
                        sources.append(os.path.join(dirpath, f))
    for path in sources:
        if budget <= 0:
            break
        try:
            with open(path, "rb") as f:
                data = f.read(min(budget, 1 << 20))
        except OSError:
            continue
        budget -= len(data)
        counter.update(_WORD_RE.findall(data.lower()))
    if len(counter) < 200:   # pathological image: fall back to the seed
        counter.update({w.encode(): 1000 - i
                        for i, w in enumerate(_SEED)})
    ranked = counter.most_common(max_words)
    words = [w.decode() for w, _ in ranked]
    counts = np.asarray([c for _, c in ranked], np.float64)
    return words, counts


_CONTRACTIONS = ("n't", "'s", "'ll", "'re", "'ve", "'d")


class RealisticCorpus:
    """Deterministic generator of realistic document byte-payloads."""

    def __init__(self, rng, words: list[str] | None = None,
                 zipf_a: float = 1.15) -> None:
        self.rng = rng
        if words is None:
            words, _ = harvest_lexicon()
        self.words = words
        ranks = np.arange(1, len(words) + 1, dtype=np.float64)
        p = ranks ** (-zipf_a)
        self.p = p / p.sum()

    def _sample_words(self, n: int) -> list[str]:
        idx = self.rng.choice(len(self.words), size=n, p=self.p)
        return [self.words[i] for i in idx]

    def make_text(self, avg_len: int) -> str:
        """One plain-text document: sentences with casing, punctuation,
        contractions, numbers, paragraph breaks."""
        rng = self.rng
        n = max(8, int(rng.poisson(avg_len)))
        toks = self._sample_words(n)
        out: list[str] = []
        sent_pos = 0
        for i, w in enumerate(toks):
            r = rng.random()
            if r < 0.03:
                w = w + _CONTRACTIONS[int(rng.integers(
                    0, len(_CONTRACTIONS)))]
            elif r < 0.08:
                w = str(int(rng.integers(0, 100000)))
            if sent_pos == 0:
                w = w.capitalize()
            sent_pos += 1
            end = sent_pos >= int(rng.integers(5, 18)) or i == n - 1
            if end:
                w += "."
                sent_pos = 0
                if rng.random() < 0.15:
                    w += "\n\n"
            elif rng.random() < 0.08:
                w += ","
            out.append(w)
        return " ".join(out)

    def make_payload(self, avg_len: int, *, html_frac: float = 0.03,
                     latin1_frac: float = 0.02,
                     binary_frac: float = 0.005
                     ) -> tuple[bytes, str]:
        """One document as raw upload bytes.

        Returns ``(payload, kind)`` with kind in ``plain`` / ``html`` /
        ``latin1`` / ``binary``; ``binary`` payloads must be refused by
        the ingest contract (415)."""
        r = self.rng.random()
        if r < binary_frac:
            # realistic stray binaries: recognized magic + random bytes
            # (a PNG, a JPEG, an ELF, a gzip — what actually lands in a
            # documents folder by accident). These must 415.
            magics = (b"\x89PNG\r\n\x1a\n", b"\xff\xd8\xff\xe0",
                      b"\x7fELF", b"\x1f\x8b\x08")
            magic = magics[int(self.rng.integers(0, len(magics)))]
            blob = self.rng.integers(0, 256, size=512,
                                     dtype=np.uint8).tobytes()
            return magic + blob, "binary"
        text = self.make_text(avg_len)
        if r < binary_frac + html_frac:
            body = text.replace("\n\n", "</p><p>")
            return (f"<html><head><title>doc</title>"
                    f"<style>p{{margin:0}}</style></head>"
                    f"<body><p>{body}</p></body></html>"
                    ).encode(), "html"
        if r < binary_frac + html_frac + latin1_frac:
            # sprinkle Latin-1-only characters so the payload is NOT
            # valid UTF-8 and must ride the charset fallback
            text = text.replace(" the ", " caf\xe9 ", 1)
            if "\xe9" not in text:
                text = "caf\xe9 " + text
            return text.encode("latin-1"), "latin1"
        return text.encode(), "plain"
