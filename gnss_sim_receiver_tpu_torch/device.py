"""Device selection for the port's entry points.

``device=None`` means the CUDA card.  Without one the entry points raise:
they never run quietly on the CPU.  Pass ``device="cpu"`` explicitly to run
the plain PyTorch versions of the kernels (as the CPU tests do).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

# an H100 SXM's streaming multiprocessors: what the launch planners aim at
# where no card is asked (the CPU tests)
H100_SMS = 132


def resolve_device(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions of the kernels")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of `device`, a CUDA card, for the launch
    planners; H100_SMS for the CPU."""
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).multi_processor_count
    return H100_SMS


def upload(a, device: torch.device) -> torch.Tensor:
    """A host array on `device`.  To a card it goes through pinned memory
    without blocking: a copy from pageable memory would first wait for
    all the work queued on the stream."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


@contextlib.contextmanager
def device_context(device: torch.device):
    """Run the block's device work on `device`'s default stream, whatever
    thread runs it (a command thread has its own current device and
    stream)."""
    if device.type != "cuda":
        yield
        return
    with torch.cuda.device(device), \
            torch.cuda.stream(torch.cuda.default_stream(device)):
        yield


def require(t: torch.Tensor, dtype, device, what: str) -> None:
    """Raise unless `t` is what a kernel can read through its data pointer:
    `dtype`, on `device`, contiguous, and with no lazy conjugate or
    negative bit (``torch.conj`` only flags a view; the kernel would read
    the unconjugated values)."""
    if (t.dtype != dtype or t.device != device or not t.is_contiguous()
            or t.is_conj() or t.is_neg()):
        raise ValueError(f"{what} must be a contiguous, materialized "
                         f"{dtype} tensor on {device}")


def check_kernel_device(t: torch.Tensor, what: str) -> bool:
    """True when `t` lies on a CUDA device (the caller launches its
    kernel), False on the CPU (the caller runs the plain version); any
    other device raises."""
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{what}: unsupported device {t.device}")
