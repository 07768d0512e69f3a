"""Device policy of the port.

Every entry point takes ``device=`` and defaults to ``"cuda"``. There is
no fallback: asking for CUDA on a machine without a usable GPU raises, and
the CPU runs only when the caller names it (the CPU tests do). Tensors are
created on the resolved device explicitly, never on a global default.
"""
from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    """Return ``device`` as a ``torch.device``; raise when it names CUDA
    and no GPU is usable."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available()"
            " is False; pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r}")
    return dev


# CUDA errors that leave the process's CUDA context unusable ("sticky"):
# every later call on the context fails with the same error, so only a new
# process recovers. The strings are the CUDA runtime's own
# (cudaGetErrorString), which both torch's errors and the kernel wrappers'
# launch errors carry.
STICKY_CUDA_ERRORS = (
    "an illegal memory access was encountered",  # cudaErrorIllegalAddress
    "unspecified launch failure",  # cudaErrorLaunchFailure
    "misaligned address",  # cudaErrorMisalignedAddress
    "an illegal instruction was encountered",  # cudaErrorIllegalInstruction
    "device-side assert triggered",  # cudaErrorAssert
    "hardware stack error",  # cudaErrorHardwareStackError
    "invalid program counter",  # cudaErrorInvalidPc
    "uncorrectable ECC error encountered",  # cudaErrorECCUncorrectable
    "the launch timed out and was terminated",  # cudaErrorLaunchTimeout
)


def is_sticky_cuda_error(exc: BaseException) -> bool:
    """Whether ``exc``, or an exception it was raised from, is a sticky
    CUDA error (``STICKY_CUDA_ERRORS``)."""
    seen = set()
    while exc is not None and id(exc) not in seen:
        seen.add(id(exc))
        if isinstance(exc, RuntimeError) and any(
            m in str(exc) for m in STICKY_CUDA_ERRORS
        ):
            return True
        exc = exc.__cause__ or exc.__context__
    return False
