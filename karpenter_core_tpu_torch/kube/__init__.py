from karpenter_core_tpu_torch.kube.store import KubeStore

__all__ = ["KubeStore"]
