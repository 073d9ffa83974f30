"""The compute device of the port's entry points and public ops."""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """The compute device: CUDA unless the caller names another.  Raises
    when CUDA is asked for and there is none — nothing falls back."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run "
                           "the kernels' plain versions on the CPU")
    return dev


def canonical(device) -> torch.device:
    """``device`` with its index: a bare ``"cuda"`` is the current CUDA
    device, so that two names of one card compare equal."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def to_device(x: torch.Tensor, device) -> torch.Tensor:
    """``x`` on ``device`` (no copy where it already lies there).  A copy to
    a CUDA device does not make the host wait; a copy to the host does, as
    the host reads it at once."""
    device = torch.device(device)
    return x.to(device, non_blocking=device.type == "cuda")
