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
