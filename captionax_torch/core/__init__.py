"""Runtime helpers of the port."""

from captionax_torch.core.runtime import resolve_device

__all__ = ["resolve_device"]
