"""Device selection and the process-wide torch switches the port holds
(float32 product precision here, deterministic algorithms in
ops/segment.py)."""

import contextlib
import threading

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


class ProcessSwitch:
    """A process-wide torch setting that any number of threads may hold at
    once. The first holder saves the setting and puts its value in, the
    last one out restores the saved setting: one thread leaving never flips
    the setting under another that is still inside."""

    def __init__(self, get, put, value):
        self._get, self._put, self._value = get, put, value
        self._lock = threading.Lock()
        self._holders = 0
        self._saved = None

    @contextlib.contextmanager
    def hold(self):
        with self._lock:
            if self._holders == 0:
                self._saved = self._get()
                self._put(self._value)
            self._holders += 1
        try:
            yield
        finally:
            with self._lock:
                self._holders -= 1
                if self._holders == 0:
                    self._put(self._saved)


_STRICT_FP32 = ProcessSwitch(torch.get_float32_matmul_precision,
                             torch.set_float32_matmul_precision, "highest")


def strict_fp32_matmul():
    """Run the enclosed float32 products as true float32 on the card.

    ``torch.set_float32_matmul_precision`` (and its alias
    ``torch.backends.cuda.matmul.allow_tf32``) is process state that any
    import may have changed; with TF32 a product keeps 10 mantissa bits, and
    a vote at a 0.1 m threshold or a fitness score moves. The hdl path holds
    this around the float32 products it depends on (RANSAC plane votes, the
    plane refit, the tilt rotation, the fitness transform), and the threaded
    runner's workers for their whole life; the setting in force before the
    first holder comes back when the last one leaves. Float64 products are
    never reduced."""
    return _STRICT_FP32.hold()
