"""Resolve a device-count request (the device-count half of the JAX
package's ``parallel/mesh.py``; the slot-axis sharding is ROADMAP A.13)."""
from __future__ import annotations

import torch

from karpenter_core_tpu_torch.utils.device import DEFAULT_DEVICE


def _available(device) -> int:
    if torch.device(device).type == "cuda":
        return torch.cuda.device_count()
    return 1


def resolve_devices(requested, device=DEFAULT_DEVICE) -> int:
    """Resolve a device-count request against the devices of ``device``'s
    kind.

    ``1`` (the default everywhere) short-circuits without touching the
    backend. ``0``/None means "every device of the kind"
    (``torch.cuda.device_count()``, or 1 on the CPU); any other request
    clamps to what exists, so an 8-device config runs the single-device
    path on a one-GPU box instead of crashing.
    """
    requested = int(requested or 0)
    if requested == 1:
        return 1
    available = _available(device)
    if requested <= 0:
        return max(1, available)
    return max(1, min(requested, available))


def check_single_device(requested, device=DEFAULT_DEVICE, what="solves") -> int:
    """``resolve_devices``, raising where the count resolves above 1: the
    slot-axis sharding over several GPUs is ported by ROADMAP A.13."""
    n = resolve_devices(requested, device)
    if n > 1:
        raise NotImplementedError(
            f"devices={requested} resolves to {n} devices: multi-GPU {what}"
            " are ported by ROADMAP item A.13"
        )
    return n


def pad_to_devices(n: int, n_devices: int) -> int:
    """Round n up to a multiple of n_devices: ``device_put`` over the slot
    axis needs even division, and padded slots are inert by construction
    (kind=0 never takes — the slot-axis-invariance parity property)."""
    if n_devices <= 1:
        return n
    return -(-n // n_devices) * n_devices
