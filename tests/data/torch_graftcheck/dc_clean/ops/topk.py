import numpy as np
import torch


def packed(q: torch.Tensor) -> torch.Tensor:
    return q


def fetch_packed(arr):
    dev = packed(arr)
    return dev.cpu().numpy()


def unpack_topk(arr):
    host = fetch_packed(arr)
    return np.asarray(packed(torch.from_numpy(host)).tolist())
