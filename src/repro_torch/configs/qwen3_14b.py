"""qwen3-14b [dense] — qk_norm, GQA kv=8, head_dim 128 [hf:Qwen/Qwen3-14B]."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen3-14b", family="dense",
    num_layers=40, d_model=5120, num_heads=40, num_kv_heads=8,
    d_ff=17408, vocab_size=151936, head_dim=128,
    qk_norm=True, rope_theta=1_000_000.0,
))
