"""recurrentgemma-2b [hybrid] — RG-LRU + local attention, 1:2 pattern
(2 recurrent blocks then 1 local-attn block) [arXiv:2402.19427]."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="recurrentgemma-2b", family="hybrid",
    num_layers=26, d_model=2560, num_heads=10, num_kv_heads=1,
    d_ff=7680, vocab_size=256000, head_dim=256,
    block_pattern=("rglru", "rglru", "attn"),
    local_window=2048, lru_width=2560, conv_width=4,
    rope_theta=10_000.0,
))
