"""Carry problems and prepared tensors from the JAX package into the port.

* ``tensors_from_numpy(tree, device)`` turns prepared FFD tensors, given
  as numpy arrays in the field order of ``SlotState``, ``ClassStep``,
  ``FFDStatics`` or ``EvPlanes`` (the preemption pass's evictable-pod
  planes; a NamedTuple of any of those names, a tuple of them, or a dict
  keyed by field name under ``"SlotState"`` etc.), into the port's
  NamedTuples of tensors on ``device``. Dtypes are kept as given; a bare
  numpy array (a gang or tier row) becomes one tensor.
* ``from_reference(obj)`` turns an object of the reference object model
  (pods, nodepools, instance types, existing nodes, topologies, or any
  container of them) into the port's classes. It pickles the object and
  unpickles it with every ``karpenter_core_tpu.X`` class mapped to
  ``karpenter_core_tpu_torch.X``; the port's host modules are verbatim
  copies, so the classes line up one for one. Only this program's own
  objects should be passed: unpickling runs their constructors.

This module imports only the port.
"""
from __future__ import annotations

import io
import pickle

import numpy as np
import torch

from karpenter_core_tpu_torch.ops.ffd import ClassStep, FFDStatics, SlotState
from karpenter_core_tpu_torch.ops.gangsched import EvPlanes

_TYPES = {t.__name__: t for t in (SlotState, ClassStep, FFDStatics, EvPlanes)}
_REF_PKG = "karpenter_core_tpu"
_PORT_PKG = "karpenter_core_tpu_torch"


def _to_tensor(x, device):
    if x is None:
        return None
    return torch.tensor(np.array(x, order="C"), device=device)


def _convert(name: str, fields, device):
    cls = _TYPES[name]
    if isinstance(fields, dict):
        values = [fields.get(f) for f in cls._fields]
    else:
        values = list(fields)
        if len(values) > len(cls._fields):
            raise ValueError(f"{name}: {len(values)} fields, expected"
                             f" {len(cls._fields)}")
    return cls(*(_to_tensor(v, device) for v in values))


def tensors_from_numpy(tree, device="cuda"):
    """Prepared FFD tensors as numpy -> the port's tensor NamedTuples."""
    device = torch.device(device)
    name = type(tree).__name__
    if name in _TYPES:
        return _convert(name, tuple(tree), device)
    if isinstance(tree, np.ndarray):
        return _to_tensor(tree, device)
    if isinstance(tree, dict):
        return {k: _convert(k, v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tensors_from_numpy(t, device) for t in tree)
    raise TypeError(f"cannot convert {type(tree)!r}")


class _PortUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module == _REF_PKG or module.startswith(_REF_PKG + "."):
            module = _PORT_PKG + module[len(_REF_PKG):]
        return super().find_class(module, name)


def from_reference(obj):
    """An object graph of the reference's classes -> the port's classes."""
    return _PortUnpickler(io.BytesIO(pickle.dumps(obj))).load()
