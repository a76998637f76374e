"""The compute-fault classifier.

The counterpart of ``classify_compute_fault`` in
``tfidf_tpu/cluster/resilience.py``; the rest of that module (retry
policies, breakers, RPC status errors) belongs to the cluster layer and is
not in this package yet. The order is the reference's: the
``compute_fault`` attribute first, then the typed nemesis faults, then the
message marks of the device runtime's own errors (PyTorch's CUDA errors
are ``RuntimeError`` s whose class is in the message).
"""

from __future__ import annotations

# message fragments that identify a device fault class when the
# exception type alone cannot; checked in order, first hit wins. Only
# errors the port's own calls can raise: the CUDA runtime's, through
# PyTorch (it runs no cuBLAS or cuDNN call)
_COMPUTE_OOM_MARKS = ("resource_exhausted", "out of memory")
_COMPUTE_TRANSIENT_MARKS = ("cuda error", "illegal memory access",
                            "unspecified launch failure",
                            "uncorrectable ecc")


def classify_compute_fault(e: BaseException) -> str | None:
    """``"oom"`` / ``"compile"`` / ``"transient"`` / ``"poison"``, or
    None for anything that is not a device fault.

    ``torch.cuda.OutOfMemoryError`` and "CUDA out of memory" are
    ``"oom"``; a CUDA runtime error (illegal address, launch failure, ECC)
    is ``"transient"``. A kernel that fails to build or load
    (``kernels.KernelBuildError``) or whose launch is refused
    (``kernels.KernelLaunchError``) is None: both are deterministic, and a
    fallback that absorbed them would hide the kernel. A generic
    ``RuntimeError`` is None."""
    stamped = getattr(e, "compute_fault", None)
    if stamped is not None:
        return stamped
    from tfidf_tpu_torch.kernels import KernelBuildError, KernelLaunchError
    from tfidf_tpu_torch.utils.device_nemesis import (DeviceCompileError,
                                                      DeviceFault,
                                                      DeviceOOMError,
                                                      DevicePoisonedOutput)
    if isinstance(e, DevicePoisonedOutput):
        return "poison"
    if isinstance(e, DeviceOOMError):
        return "oom"
    if isinstance(e, DeviceCompileError):
        return "compile"
    if isinstance(e, DeviceFault):
        return "transient"
    if isinstance(e, (KernelBuildError, KernelLaunchError)):
        return None
    import torch
    if isinstance(e, torch.cuda.OutOfMemoryError):
        return "oom"
    if isinstance(e, RuntimeError):
        msg = str(e).lower()
        if any(m in msg for m in _COMPUTE_OOM_MARKS):
            return "oom"
        if any(m in msg for m in _COMPUTE_TRANSIENT_MARKS):
            return "transient"
    return None
