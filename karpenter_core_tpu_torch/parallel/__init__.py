"""Device count of the solve.

The device-count half of ``karpenter_core_tpu/parallel/mesh.py``: a
request resolves against the devices of its kind that exist, as in the JAX
package, so ``devices=0`` ("every device") and a count larger than the host
has both run the single-device solve on a one-GPU machine. The slot-axis
sharding over several GPUs (the rest of that module) is ROADMAP A.13; a
count that resolves above 1 raises ``NotImplementedError`` where a solver is
built.
"""
from karpenter_core_tpu_torch.parallel.mesh import (
    check_single_device,
    pad_to_devices,
    resolve_devices,
)

__all__ = ["check_single_device", "pad_to_devices", "resolve_devices"]
