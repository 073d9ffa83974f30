"""Plain PyTorch version of the WKV kernel: the Pallas kernel's chunk
arithmetic (``_wkv_kernel``) on (BH, T, K), looped over chunks with the
(K, K) f32 state carried.  T is padded with zeros to the chunk; padded
tokens come after the real ones, so the real outputs do not change.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

CLAMP = 30.0  # max |log| of the intra-chunk inverse decay factor; models/rwkv6.py imports it


def wkv_plain(r, k, v, lw, u, chunk: int = 128):
    """(BH, T, K) outputs in r.dtype; r, k, v, lw (BH, T, K), u (BH, K);
    computed in f32."""
    bh, t, kk = r.shape
    pad = (-t) % chunk
    r32, k32, v32, lw32 = (F.pad(x.float(), (0, 0, 0, pad)) for x in (r, k, v, lw))
    u32 = u.float()[:, None, :]                                   # (BH, 1, K)
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=r.device), -1)
    s = torch.zeros((bh, kk, kk), dtype=torch.float32, device=r.device)
    outs = []
    for c0 in range(0, t + pad, chunk):
        rc, kc, vc, lc = (x[:, c0:c0 + chunk] for x in (r32, k32, v32, lw32))
        lcum_inc = torch.cumsum(lc, dim=1)                        # inclusive
        lcum = lcum_inc - lc                                      # exclusive
        ltot = lcum_inc[:, -1:]                                   # (BH, 1, K)
        ri = rc * torch.exp(lcum)
        kj = kc * torch.exp(torch.clamp(-lcum_inc, -CLAMP, CLAMP))
        scores = torch.where(mask, ri @ kj.transpose(1, 2), 0.0)  # strictly past
        intra = scores @ vc
        diag = torch.sum(rc * (kc * u32), dim=2, keepdim=True)    # (BH, C, 1)
        intra = intra + diag * vc
        inter = ri @ s                                            # the state before the update
        k_carry = kc * torch.exp(torch.clamp(ltot - lcum_inc, max=CLAMP))
        s = s * torch.exp(ltot).transpose(1, 2) + k_carry.transpose(1, 2) @ vc
        outs.append(intra + inter)
    return torch.cat(outs, dim=1)[:, :t].to(r.dtype)
