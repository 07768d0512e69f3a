"""Device mesh and placement of the multi-device solve.

Port of ``karpenter_core_tpu/parallel/mesh.py`` in PyTorch's terms. A mesh
is an ordered tuple of ``torch.device``s (``SlotMesh``); its first device is
the lead. Where each piece of the JAX module went:

* ``resolve_devices``, ``pad_to_devices`` and ``slot_mesh``: here, with
  the same semantics (``slot_mesh`` takes the first n devices of a kind,
  as ``jax.devices()[:n]``, and raises when fewer exist).
* ``replicated``, ``pallas_slot_shardings`` and ``relax_plane_shardings``:
  the mesh's lead device. The JAX kernel route commits every plane whole
  on every device and computes the same answer on each; in one process
  that is the computation done once, so the port's scheduler prepares
  every plane on the lead device and computes it there once. The sweep's
  read-only planes, which every prefix shard reads, go to every device of
  the mesh once (``on_each``).
* ``batch_sharding`` (the sweep's prefix axis): ``row_shards``,
  ``split_rows`` and ``gather_rows``: contiguous shards of a leading
  problem axis, one a device, and their results put back in row order on
  the lead device. The port splits the batched problem axis the same way
  (JAX replicates it and splits slots): a problem's scan then needs no
  exchange between devices.
* ``SLOT_STATE_SPECS``, ``CLASS_STEP_SPECS``, ``GANG_EV_SPECS``,
  ``axis_sharding``, ``slot_shardings``, ``gang_plane_shardings``, the
  ``batched_*_shardings`` and ``topo_plane_shardings``: not ported. They
  serve JAX's XLA route, which splits the slot axis under GSPMD and carries
  the first fit's prefix sum between devices on every step. The port's
  kernel is the counterpart of the Pallas route, which takes whole planes;
  a slot split would need an exchange between GPUs inside the persistent
  kernel on every class step (ROADMAP queue B).
* ``utils/jaxenv.force_virtual_cpu_mesh``: ``force_virtual_mesh``, a test
  hook that makes n devices of a kind out of the physical ones.
"""
from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from karpenter_core_tpu_torch.utils.device import DEFAULT_DEVICE

# kind -> device count set by force_virtual_mesh
_virtual: dict = {}


def force_virtual_mesh(n_devices, kind=DEFAULT_DEVICE) -> None:
    """Count ``n_devices`` devices of ``kind`` from now on (a test hook;
    the counterpart of ``jaxenv.force_virtual_cpu_mesh``). ``slot_mesh``
    then lays the n shards over that kind's physical devices in turn: n
    ``cpu`` devices on the CPU, n shards on ``cuda:0`` on a one-GPU host.
    ``0`` or None goes back to the physical count. No entry point calls
    it."""
    kind = torch.device(kind).type
    if n_devices:
        _virtual[kind] = int(n_devices)
    else:
        _virtual.pop(kind, None)


def _physical(kind: str) -> int:
    if kind == "cuda":
        return torch.cuda.device_count()
    return 1


def _available(device) -> int:
    kind = torch.device(device).type
    return _virtual.get(kind, _physical(kind))


def resolve_devices(requested, device=DEFAULT_DEVICE) -> int:
    """Resolve a device-count request against the devices of ``device``'s
    kind.

    ``1`` (the default everywhere) short-circuits without touching the
    backend. ``0``/None means "every device of the kind"
    (``torch.cuda.device_count()``, or 1 on the CPU, unless
    ``force_virtual_mesh`` set another count); any other request clamps to
    what exists, so an 8-device config runs the single-device path on a
    one-GPU box instead of crashing.
    """
    requested = int(requested or 0)
    if requested == 1:
        return 1
    available = _available(device)
    if requested <= 0:
        return max(1, available)
    return max(1, min(requested, available))


def pad_to_devices(n: int, n_devices: int) -> int:
    """Round n up to a multiple of n_devices: ``device_put`` over the slot
    axis needs even division, and padded slots are inert by construction
    (kind=0 never takes — the slot-axis-invariance parity property)."""
    if n_devices <= 1:
        return n
    return -(-n // n_devices) * n_devices


class SlotMesh(NamedTuple):
    """An ordered tuple of devices; the first is the lead."""

    devices: Tuple[torch.device, ...]

    @property
    def lead(self) -> torch.device:
        return self.devices[0]

    @property
    def size(self) -> int:
        return len(self.devices)


def slot_mesh(n_devices: int, device=DEFAULT_DEVICE) -> SlotMesh:
    """A mesh over the first ``n_devices`` devices of ``device``'s kind
    (JAX's ``slot_mesh``: ``jax.devices()[:n]``). Raises when fewer exist;
    it never falls back to fewer devices or to the CPU. On a virtual mesh
    (``force_virtual_mesh``) the shards go over the physical devices in
    turn. A mesh of one device is ``device`` itself."""
    n = int(n_devices)
    if n == 1:
        return SlotMesh((torch.device(device),))
    kind = torch.device(device).type
    have, physical = _available(kind), _physical(kind)
    if n < 1 or n > have or physical < 1:
        raise RuntimeError(
            f"need {n} {kind} devices, have {have}"
            f" ({physical} physical)"
        )
    if kind == "cpu":
        return SlotMesh((torch.device("cpu"),) * n)
    return SlotMesh(tuple(torch.device(kind, i % physical) for i in range(n)))


def _map(tree, fn):
    """``fn`` over every tensor leaf of a tensor, a NamedTuple or a tuple
    (None leaves stay None)."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if hasattr(tree, "_fields"):
        return type(tree)(*(_map(x, fn) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(x, fn) for x in tree)
    return tree


def on_each(mesh: SlotMesh, tree) -> list:
    """``tree`` on every device of the mesh, copied once a physical device
    (the list is aligned with ``mesh.devices``): JAX's ``replicated``
    commit of the sweep's read-only planes."""
    copies = {}
    for dev in mesh.devices:
        if dev not in copies:
            copies[dev] = _map(tree, lambda x: x.to(dev))
    return [copies[dev] for dev in mesh.devices]


def row_shards(n_rows: int, mesh: SlotMesh) -> List[Tuple[int, int, torch.device]]:
    """Contiguous shards ``(lo, hi, device)`` of a leading axis of
    ``n_rows``, one a device, the first ``n_rows % size`` a row larger
    (JAX's ``batch_sharding``); a device left with no row gets no shard."""
    base, extra = divmod(n_rows, mesh.size)
    out, lo = [], 0
    for k, dev in enumerate(mesh.devices):
        hi = lo + base + (k < extra)
        if hi > lo:
            out.append((lo, hi, dev))
        lo = hi
    return out


def split_rows(tree, lo: int, hi: int, device):
    """Rows ``[lo, hi)`` of every tensor of ``tree``, on ``device``."""
    return _map(tree, lambda x: x[lo:hi].to(device))


def gather_rows(mesh: SlotMesh, parts):
    """The shards' results (trees of equal structure, in row order) put
    back together on the lead device. A copy from another device follows
    the work queued on that device's current stream. One part is the
    result as it stands."""
    if len(parts) == 1:
        return parts[0]
    head = parts[0]
    if head is None:
        return None
    if isinstance(head, torch.Tensor):
        return torch.cat([p.to(mesh.lead) for p in parts])
    leaves = [gather_rows(mesh, list(xs)) for xs in zip(*parts)]
    return type(head)(*leaves) if hasattr(head, "_fields") else type(head)(
        leaves)


def pad_rows(a: np.ndarray, n_devices: int) -> np.ndarray:
    """``a``'s leading axis padded to a multiple of ``n_devices`` with
    copies of its last row (the sweep's prefix pad)."""
    pad = pad_to_devices(a.shape[0], n_devices) - a.shape[0]
    if not pad:
        return a
    return np.concatenate([a, np.repeat(a[-1:], pad, axis=0)])
