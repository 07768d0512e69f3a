from karpenter_core_tpu_torch.scheduling.requirement import Requirement  # noqa: F401
from karpenter_core_tpu_torch.scheduling.requirements import Requirements  # noqa: F401
from karpenter_core_tpu_torch.scheduling.taints import Taints, KNOWN_EPHEMERAL_TAINTS  # noqa: F401
