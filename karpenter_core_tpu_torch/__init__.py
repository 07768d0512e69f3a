"""karpenter_core_tpu_torch — the PyTorch/CUDA port of karpenter_core_tpu.

The same cluster-autoscaling system with its device solve written in
PyTorch for an NVIDIA H100: the pod-class first-fit-decreasing scan runs as
a hand-written CUDA kernel (``ops/cuda_ffd.py`` over ``csrc/ffd_step.cu``),
with a plain PyTorch version of every device function beside it
(``ops/ffd.py``, ``ops/masks.py``).

The layout mirrors ``karpenter_core_tpu`` module for module, so each port
module sits under the same path as its counterpart. The host-side modules
(``api``, ``scheduling``, ``utils``, ``cloudprovider``, ``metrics``,
``events``, ``controllers/provisioning/scheduling``, ``solver/{vocab,
gangs,snapshot,verify}``, ``ops/topoplan``) are verbatim copies with only
the package name rewritten; ``tests/test_torch_layout.py`` holds them to
that. The port imports no JAX and nothing of ``karpenter_core_tpu``.

Device policy: every entry point takes ``device=`` and defaults to
``"cuda"``; with no GPU it raises unless the caller asks for ``"cpu"``
(``utils/device.py``).
"""
