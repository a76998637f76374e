import numpy as np
import torch


def score(q: torch.Tensor) -> torch.Tensor:
    return q * 2.0


class Sync:
    """One device->host sync form per method (each a cone root)."""

    def item(self, q):
        return score(q).max().item()

    def tolist(self, q):
        return torch.topk(q, 3).values.tolist()

    def cpu(self, q):
        return score(q).cpu()

    def numpy(self, q):
        s = torch.zeros(4)
        return s.numpy()

    def to_cpu(self, q):
        return score(q).to("cpu")

    def to_cpu_kw(self, q):
        return score(q).to(device="cpu")

    def int_(self, q):
        return int(score(q).sum())

    def float_(self, q):
        return float(torch.max(q))

    def bool_(self, q):
        return bool(score(q).any())

    def truthiness_if(self, q):
        best = score(q).max()
        if best > 0:
            return 1
        return 0

    def truthiness_while(self, q: torch.Tensor):
        while q.sum() > 0:
            q = q - 1
        return q

    def truthiness_assert(self, q):
        s = score(q)
        assert s.isfinite().all()
        return s

    def truthiness_and(self, q):
        s = score(q)
        return s.any() and 1

    def truthiness_not(self, q):
        s = score(q)
        return not s.any()

    def asarray(self, q):
        return np.asarray(score(q))

    def array(self, q):
        return np.array(score(q))

    def nonzero_fn(self, q):
        return torch.nonzero(q)

    def nonzero_method(self, q):
        s = score(q)
        return s.nonzero()

    def argwhere(self, q):
        return torch.argwhere(q)

    def where_one_arg(self, q):
        return torch.where(q > 0)

    def unique(self, q):
        return torch.unique(q)

    def unique_method(self, q):
        return score(q).unique()

    def masked_select(self, q):
        return torch.masked_select(q, q > 0)

    def mask_index(self, q):
        s = score(q)
        keep = s > 0
        return s[keep]

    def mask_index_isfinite(self, q):
        s = score(q)
        return s[torch.isfinite(s)]

    def mask_store(self, q):
        s = score(q)
        s[s < 0] = 0.0
        return s

    def sync_device(self, q):
        torch.cuda.synchronize()
        return q

    def sync_event(self, q):
        ev = torch.cuda.Event()
        ev.record()
        ev.synchronize()
        return q

    def sync_stream(self, q):
        torch.cuda.current_stream().synchronize()
        return q
