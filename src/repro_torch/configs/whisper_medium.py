"""whisper-medium [audio] — enc-dec; conv frontend STUB (precomputed frame
embeddings) [arXiv:2212.04356]."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="whisper-medium", family="audio",
    num_layers=24, d_model=1024, num_heads=16, num_kv_heads=16,
    d_ff=4096, vocab_size=51865,
    is_encoder_decoder=True, num_encoder_layers=24, encoder_seq=1500,
    learned_pos=True, norm_eps=1e-5,
))
