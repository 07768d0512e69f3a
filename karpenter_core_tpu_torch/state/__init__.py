from karpenter_core_tpu_torch.state.cluster import Cluster, StateNode

__all__ = ["Cluster", "StateNode"]
