"""Import every architecture config module (populates the registry)."""
from repro_torch.configs import (  # noqa: F401
    deepseek_7b,
    llama32_vision_11b,
    olmoe_1b_7b,
    phi35_moe,
    qwen15_05b,
    qwen3_06b,
    qwen3_14b,
    recurrentgemma_2b,
    rwkv6_3b,
    whisper_medium,
)
