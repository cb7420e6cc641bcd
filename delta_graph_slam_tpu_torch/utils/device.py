"""Device selection and float32 product precision for the port's stages."""

import contextlib

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


@contextlib.contextmanager
def strict_fp32_matmul():
    """Run the enclosed float32 products as true float32 on the card.

    ``torch.set_float32_matmul_precision`` (and its alias
    ``torch.backends.cuda.matmul.allow_tf32``) is process state that any
    import may have changed; with TF32 a product keeps 10 mantissa bits, and
    a vote at a 0.1 m threshold or a fitness score moves. The hdl path holds
    this around the float32 products it depends on (RANSAC plane votes, the
    plane refit, the tilt rotation, the fitness transform) and restores the
    setting afterwards. Float64 products are never reduced."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)
