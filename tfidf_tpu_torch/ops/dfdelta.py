"""Sparse df maintenance on a torch device — the O(batch) commit primitive.

The counterpart of ``tfidf_tpu/ops/dfdelta.py``. Global document frequency
is a ``[vocab_cap]`` f32 tensor on the scoring device. Recomputing it on
the host per commit is O(corpus nnz), and re-uploading the dense array per
commit is O(vocab) transfer; instead

* mutations journal ``(term_ids, delta)`` pairs — O(1) bookkeeping per
  mutation, O(batch nnz) per commit;
* commit folds the whole journal into the previous committed df with ONE
  sparse add over the coalesced ids;
* df counts are integer-valued f32 adds — exact while below 2^24, so the
  incremental path is bit-equal to a full recompute whatever order the
  adds land in (CUDA atomics included).

Two differences from the JAX applier, both forced by torch:

* the JAX scatter pads its index array out of bounds and relies on
  ``mode="drop"``; ``index_add`` raises on an out-of-bounds index on the
  CPU and trips a device-side assert on CUDA. So only the real ids go in
  (ids past the df's length are dropped on the host, as the pads were);
  there is no per-shape compile cache to pad for;
* the apply is OUT of place (``Tensor.index_add``, not ``index_add_``):
  a published snapshot holds the previous df, and callers holding it must
  keep their unmodified df — JAX arrays are immutable, torch tensors are
  not.
"""

from __future__ import annotations

import numpy as np
import torch


class DfDeltaApplier:
    """Journaled sparse updates to a device-resident df tensor."""

    def __init__(self) -> None:
        self.journal: list[tuple[np.ndarray, object]] = []

    def record(self, ids: np.ndarray, delta) -> None:
        """Journal a df change: ``delta`` is a scalar applied to every
        id (upsert/delete: +1/-1 per distinct term) or a per-id array
        (segment append/splice: the segment's sparse df counts)."""
        if ids.shape[0]:
            self.journal.append((ids, delta))

    def clear(self) -> None:
        self.journal = []

    def _coalesced(self) -> tuple[np.ndarray, np.ndarray] | None:
        """(unique ids, net f32 deltas) over the journal; None if the
        journal nets out to nothing."""
        if not self.journal:
            return None
        allids = np.concatenate([ids for ids, _d in self.journal])
        deltas = np.concatenate(
            [np.broadcast_to(np.asarray(d, np.float32), ids.shape)
             for ids, d in self.journal])
        uniq, inv = np.unique(allids, return_inverse=True)
        dv = np.bincount(inv, weights=deltas).astype(np.float32)
        nz = dv != 0
        uniq, dv = uniq[nz], dv[nz]
        if uniq.shape[0] == 0:
            return None
        return uniq.astype(np.int64), dv

    def apply(self, df_g: torch.Tensor) -> torch.Tensor:
        """Fold the journal into a NEW tensor and clear it; ``df_g`` is
        left as it was."""
        coalesced = self._coalesced()
        self.journal = []
        if coalesced is None:
            return df_g
        uniq, dv = coalesced
        keep = uniq < df_g.shape[0]           # what mode="drop" drops
        idx = torch.from_numpy(uniq[keep]).to(df_g.device)
        vals = torch.from_numpy(dv[keep]).to(df_g.device)
        return df_g.index_add(0, idx, vals)
