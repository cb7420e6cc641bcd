"""Device selection for the port's stages."""

import torch

# Where every stage runs unless the caller names another device: the card.
# A host without one raises at construction (resolve_device); pass
# device="cpu" to run the plain versions on the CPU.
DEFAULT_DEVICE = "cuda"


def resolve_device(device) -> torch.device:
    """The requested device, or an error: a CUDA request on a host without a
    usable card raises instead of carrying on on the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device} requested but torch.cuda.is_available() is False"
            )
        if device.index is None:  # tensors report cuda:N, so name N
            device = torch.device("cuda", torch.cuda.current_device())
    return device
