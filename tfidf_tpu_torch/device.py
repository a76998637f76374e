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
