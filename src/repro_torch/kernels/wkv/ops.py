"""Public op: fused WKV in the model layout.

``wkv(r, k, v, lw, u)`` takes the model layout (B, T, H, K) + u (H, K),
flattens heads into the kernel's batch and broadcasts u over the batch.
T need not be a multiple of the chunk: the kernel treats tokens past T as
zero padding.  Drop-in for ``models/rwkv6._chunked_wkv``.
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.wkv.kernel import wkv_cuda


def wkv(r, k, v, lw, u, chunk: int = 128, device=None):
    """(B, T, H, K) outputs in r.dtype on ``device`` (CUDA unless named)."""
    dev = resolve_device(device)
    b, t, h, kk = r.shape

    def flat(x):
        return x.to(dev).transpose(1, 2).reshape(b * h, t, kk).contiguous()

    uf = u.to(device=dev, dtype=torch.float32)[None].expand(b, h, kk).reshape(b * h, kk)
    out = wkv_cuda(flat(r), flat(k), flat(v), flat(lw), uf.contiguous(), chunk=chunk)
    return out.reshape(b, h, t, kk).transpose(1, 2)
