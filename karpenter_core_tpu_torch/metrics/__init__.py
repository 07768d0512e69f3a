from karpenter_core_tpu_torch.metrics.registry import (
    Counter,
    Gauge,
    Histogram,
    Registry,
    REGISTRY,
)

__all__ = ["Counter", "Gauge", "Histogram", "Registry", "REGISTRY"]
