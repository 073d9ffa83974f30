"""Model zoo (the JAX package's ``models/``): every family of the configs —
dense, MoE, RWKV6 (ssm), the RG-LRU hybrid, VLM and the audio enc-dec."""
from repro_torch.models.model import (
    abstract_params,
    decode_step,
    forward,
    init_params,
    loss_fn,
    make_serve_cache,
    prefill,
)

__all__ = [
    "init_params", "abstract_params", "forward", "loss_fn",
    "make_serve_cache", "prefill", "decode_step",
]
