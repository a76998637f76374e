import numpy as np
import torch


def score(q: torch.Tensor) -> torch.Tensor:
    return q * 2.0


def host_weights(n: int) -> np.ndarray:
    return np.ones(n, np.float32)


class Clean:
    """The same shapes of code on host values: none is a sync."""

    def metadata(self, q):
        s = score(q)
        n = int(s.shape[0])
        d = s.dim()
        return n + d + s.numel()

    def identity(self, q, out=None):
        s = score(q)
        if out is None:
            out = s
        if s is not out:
            return s
        return out

    def host_values(self, q):
        w = host_weights(4)
        if w.sum() > 0:
            return float(w.max()) + len(w.tolist())
        return np.asarray(w).nonzero()

    def host_alloc(self, q):
        staged = torch.empty((4,), dtype=torch.float32, pin_memory=True)
        staged.numpy()[...] = 1.0
        on_cpu = torch.zeros(4, device="cpu")
        return on_cpu.numpy(), torch.from_numpy(np.ones(3)).numpy()

    def two_arg_where(self, q):
        s = score(q)
        return torch.where(s > 0, s, torch.zeros_like(s))

    def python_scalars(self, n: int, k: int):
        if n > k and not n == 0:
            return int(n) + float(k)
        return bool(k)
