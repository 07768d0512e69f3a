from karpenter_core_tpu_torch.api import labels  # noqa: F401
