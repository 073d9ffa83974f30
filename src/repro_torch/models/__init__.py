"""Model zoo (the JAX package's ``models/``): every family of the configs —
dense, MoE, RWKV6 (ssm), the RG-LRU hybrid, VLM and the audio enc-dec."""
from repro_torch.models.model import (
    decode_step,
    forward,
    init_params,
    make_serve_cache,
    prefill,
)

__all__ = [
    "init_params", "forward",
    "make_serve_cache", "prefill", "decode_step",
]
