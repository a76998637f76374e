"""Device resolution for the port's entry points.

Every entry point takes ``device``: ``None`` means the GPU and raises when
CUDA is absent — the port never drops to the CPU quietly, because a CPU
number passed off as a device number is the one mistake a measurement
cannot recover from. Tests pass ``device="cpu"`` explicitly, which routes
each kernel wrapper to its plain PyTorch version.

Numerics: the reference pays for full f32 on purpose (the Pallas kernel's
contraction runs at ``Precision.HIGHEST``; bf16 passes cost ~0.4%
relative error, enough to flip top-k near-ties — ``tfidf_tpu/ops/ell.py``).
So TF32 is switched off for matmuls and cuDNN the first time a device is
resolved; nothing on the scoring path may run in reduced precision.
"""

from __future__ import annotations

import numpy as np
import torch

_PRECISION_SET = False


def set_full_f32() -> None:
    """Pin f32 matmul / convolution precision (no TF32) — idempotent."""
    global _PRECISION_SET
    if not _PRECISION_SET:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        _PRECISION_SET = True


def resolve_device(device: str | torch.device | None = None
                   ) -> torch.device:
    """``None`` -> ``cuda`` (raises without CUDA); anything else as given.
    A ``cuda`` device asked for on a machine without CUDA raises too."""
    set_full_f32()
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "tfidf_tpu_torch: CUDA is not available and no device was "
                "named; pass device='cpu' to run the plain PyTorch path")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"tfidf_tpu_torch: device {dev} requested but "
                           "CUDA is not available")
    return dev


def upload(arr, device: torch.device, stream=None) -> torch.Tensor:
    """A host numpy array as a tensor on ``device``.

    The CPU gets a tensor of its own (a copy when ``arr`` is read-only —
    an npz member, a read-only memmap — else ``arr``'s memory, which the
    callers never write again). On CUDA without ``stream`` it is a plain
    copy on the current stream. With ``stream`` (a background merge, the
    tier's upload ring) the array is staged in pinned memory and copied
    ``non_blocking`` on that stream; the tensor is then marked as used by
    the device's default stream, where scoring runs, so the caching
    allocator never hands its memory to the side stream while a search
    may still read it. The caller records an event on ``stream`` after
    its uploads, and scoring waits on that event."""
    a = np.asarray(arr)
    if device.type != "cuda" or stream is None:
        if not a.flags.writeable or isinstance(a, np.memmap):
            a = np.array(a)
        t = torch.from_numpy(a)
        return t if device.type != "cuda" else t.to(device)
    # one host copy, straight from the array (a memmap's pages) into the
    # pinned staging buffer; the pinned allocator keeps the buffer until
    # the copy that reads it has completed
    dtype = torch.from_numpy(np.empty(0, a.dtype)).dtype
    staged = torch.empty(a.shape, dtype=dtype, pin_memory=True)
    staged.numpy()[...] = a
    with torch.cuda.stream(stream):
        t = staged.to(device, non_blocking=True)
    t.record_stream(torch.cuda.default_stream(device))
    return t


def zeros_on(n: int, device: torch.device, stream=None) -> torch.Tensor:
    """f32 zeros ``[n]`` on ``device``, allocated on ``stream`` when given
    (then marked like :func:`upload`'s tensors)."""
    if device.type != "cuda" or stream is None:
        return torch.zeros(n, dtype=torch.float32, device=device)
    with torch.cuda.stream(stream):
        t = torch.zeros(n, dtype=torch.float32, device=device)
    t.record_stream(torch.cuda.default_stream(device))
    return t
