"""olmoe-1b-7b [moe] — 64 experts top-8 [arXiv:2409.02060; hf]."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="olmoe-1b-7b", family="moe",
    num_layers=16, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=1024, vocab_size=50304,
    num_experts=64, num_experts_per_tok=8,
    rope_theta=10_000.0,
    # Perf-tuned (EXPERIMENTS.md): 6.9B params, tiny per-expert d_ff —
    # activation/dispatch collectives dominate param sync, so pure FSDP
    # halves the roofline bound (2.0x)
    sharding_mode="fsdp",
))
