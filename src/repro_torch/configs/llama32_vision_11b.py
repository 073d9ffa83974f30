"""llama-3.2-vision-11b [vlm] — cross-attn image layers every 5th layer.

The vision tower is a STUB per assignment: input_specs() provides
precomputed patch embeddings (projected to d_model)."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="llama-3.2-vision-11b", family="vlm",
    num_layers=40, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=128256,
    rope_theta=500_000.0,
    cross_attn_every=5, num_patches=1601,
    # Perf-tuned: vlm units remat 4 self layers + cross at once; query-
    # chunked attention from 4k keeps the remat footprint in HBM
    # (temp 34.5 -> 17.5 GiB, bound -27%; EXPERIMENTS.md §Perf)
    chunked_attn_min_seq=4096,
))
