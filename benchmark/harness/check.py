"""The comparison that decides ``correct``.

For each checked query the system's hits ``[(name, score)]`` are set
beside the reference's top-k and the reference's score of every name:

* ``score_gap``: the largest gap, rank by rank, between the system's
  score and the reference's (a missing rank reads 0), over the query's
  best reference score. A left-out or extra hit, or a wrong score, shows.
* ``doc_gap``: the largest gap between a returned hit's score and the
  reference's score of that name (0 when the name is not live), over the
  query's best reference score. A wrong, deleted or replaced document
  shows even where its score is near the one it displaced.

Documents whose reference scores tie, or lie within rounding of each
other, may trade places without moving either number. Every number
compared has its own limit; the run is correct when each is within it.
"""

from __future__ import annotations

import sys


def gaps(got: list, ref_top: list, ref_score) -> tuple[float, float]:
    """(score_gap, doc_gap) of one query: ``got`` and ``ref_top`` are
    ``[(name, score)]`` in rank order; ``ref_score(name)`` is the
    reference's score of a name (0 when it is not live)."""
    top = ref_top[0][1] if ref_top else 0.0
    if top <= 0.0:
        # the reference finds nothing: any hit is wrong by its whole score
        return ((max(s for _n, s in got) if got else 0.0),) * 2
    rank = 0.0
    for r in range(max(len(got), len(ref_top))):
        a = got[r][1] if r < len(got) else 0.0
        b = ref_top[r][1] if r < len(ref_top) else 0.0
        rank = max(rank, abs(a - b) / top)
    doc = max((abs(s - ref_score(n)) / top for n, s in got), default=0.0)
    return rank, doc


class Verdict:
    """Numbers compared, each beside its limit."""

    def __init__(self, limits: dict) -> None:
        self.limits = dict(limits)
        self.values: dict[str, float] = {}

    def set(self, name: str, value: float) -> None:
        if name not in self.limits:
            raise KeyError(f"no limit for {name!r}")
        self.values[name] = float(value)

    @property
    def correct(self) -> bool:
        return (set(self.values) == set(self.limits)
                and all(self.values[k] <= self.limits[k]
                        for k in self.limits))

    def table(self) -> dict:
        return {k: {"value": self.values.get(k), "limit": self.limits[k]}
                for k in self.limits}

    def print_last(self) -> None:
        """The numbers compared, as the last lines of standard error."""
        for k, lim in self.limits.items():
            v = self.values.get(k)
            ok = v is not None and v <= lim
            print(f"compared {k} {v!r} limit {lim!r} "
                  f"{'ok' if ok else 'FAILED'}", file=sys.stderr)
        sys.stderr.flush()
