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
