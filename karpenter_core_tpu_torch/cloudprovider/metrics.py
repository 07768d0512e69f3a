"""CloudProvider metrics decorator (reference: pkg/cloudprovider/metrics/
cloudprovider.go): wraps any provider with per-method duration histograms
and error counters, transparently forwarding everything else.
"""
from __future__ import annotations

from karpenter_core_tpu_torch.metrics.registry import REGISTRY

METHOD_DURATION = REGISTRY.histogram(
    "cloudprovider_duration_seconds",
    "Duration of cloud provider method calls",
)
METHOD_ERRORS = REGISTRY.counter(
    "cloudprovider_errors_total",
    "Cloud provider method errors, by method and error type",
)

_WRAPPED = (
    "create",
    "delete",
    "get",
    "list",
    "get_instance_types",
    "is_drifted",
    "repair_policies",
)


class MetricsDecorator:
    """decorator.Decorate(cloudProvider) — same interface, instrumented."""

    def __init__(self, provider):
        self._provider = provider

    def __getattr__(self, name: str):
        attr = getattr(self._provider, name)
        if name not in _WRAPPED or not callable(attr):
            return attr

        def wrapped(*args, **kwargs):
            labels = {
                "method": name,
                "provider": type(self._provider).__name__,
            }
            with METHOD_DURATION.time(labels):
                try:
                    return attr(*args, **kwargs)
                except Exception as e:
                    METHOD_ERRORS.inc(
                        {**labels, "error": type(e).__name__}
                    )
                    raise

        return wrapped
