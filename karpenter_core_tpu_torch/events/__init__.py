from karpenter_core_tpu_torch.events.recorder import Event, Recorder

__all__ = ["Event", "Recorder"]
