from karpenter_core_tpu_torch.cloudprovider.types import (  # noqa: F401
    CloudProvider,
    InstanceType,
    Offering,
    Offerings,
    InsufficientCapacityError,
    NodeClaimNotFoundError,
)
