"""Device mesh and placement of the solve.

Port of ``karpenter_core_tpu/parallel``: a device-count request resolves
against the devices of its kind that exist, as in the JAX package, and a
count above 1 builds a mesh of that many devices (``slot_mesh``). The
port's kernel takes whole planes, as the JAX package's Pallas route does:
the solo routes run on the mesh's lead device, and the work that splits
with no exchange between devices, the consolidation sweep's prefix axis
and the batched problem axis, splits into contiguous shards, one a
device (``parallel/mesh.py`` says where each JAX sharding went).
"""
from karpenter_core_tpu_torch.parallel.mesh import (
    SlotMesh,
    force_virtual_mesh,
    gather_rows,
    on_each,
    pad_rows,
    pad_to_devices,
    resolve_devices,
    row_shards,
    slot_mesh,
    split_rows,
)

__all__ = [
    "SlotMesh",
    "force_virtual_mesh",
    "gather_rows",
    "on_each",
    "pad_rows",
    "pad_to_devices",
    "resolve_devices",
    "row_shards",
    "slot_mesh",
    "split_rows",
]
