"""rwkv6-3b [ssm] — Finch, data-dependent decay, attention-free [arXiv:2404.05892]."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="rwkv6-3b", family="ssm",
    num_layers=32, d_model=2560, num_heads=0, num_kv_heads=0,
    d_ff=8960, vocab_size=65536,
    rwkv_head_size=64,
    # Perf-tuned (EXPERIMENTS.md): chunk 128 (memory -37%) + pure FSDP
    # (40 heads don't split 16-way TP; activation gathers dominated)
    # -> 4.2x better roofline bound than the 2d default
    rwkv_chunk=128,
    sharding_mode="fsdp",
))
