"""Model zoo (the JAX package's ``models/``): the dense and RWKV6 (ssm)
backbones so far; MoE, the RG-LRU hybrid, enc-dec and VLM come later
(ROADMAP item 11)."""
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
