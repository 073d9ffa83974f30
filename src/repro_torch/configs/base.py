"""Model configuration system (a copy of the JAX package's
``configs/base.py``; the port keeps its own, and ``reduced()`` is the
same, so the CPU tests build identical models in both packages).

One frozen dataclass covers all assigned families (dense / moe / ssm /
hybrid / vlm / audio enc-dec); family-specific fields are zero/empty when
unused.  Every architecture registers itself in ``REGISTRY`` via its
``src/repro_torch/configs/<id>.py`` module; ``get_config(name)`` is the single
lookup used by the launcher (``--arch <id>``).

``reduced()`` produces the small same-family config used by the per-arch
CPU smoke tests (the full config is only ever lowered abstractly by the
dry-run).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int                 # 0 for attention-free (rwkv)
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // num_heads

    # attention options
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    sliding_window: int = 0        # 0 = full causal

    # MoE
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_group_size: int = 1024     # dispatch-einsum tokens per group (memory knob)
    capacity_factor: float = 1.25

    # rwkv6
    rwkv_head_size: int = 64
    rwkv_chunk: int = 32

    # hybrid (recurrentgemma): block pattern repeated over depth
    block_pattern: Tuple[str, ...] = ()   # e.g. ("rglru", "rglru", "attn")
    local_window: int = 0
    conv_width: int = 4
    lru_width: int = 0             # 0 -> d_model

    # encoder-decoder (whisper)
    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0
    encoder_seq: int = 0           # stub frontend frames
    learned_pos: bool = False      # whisper uses learned/abs positions

    # vlm
    cross_attn_every: int = 0      # a cross-attn layer after every N-1 self layers
    num_patches: int = 0           # stub patch embeddings

    # misc
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    remat: bool = True
    remat_policy: str = "full"     # full | dots (save matmul outputs)
    chunked_attn_min_seq: int = 0  # 0 -> module default (8192)
    # per-arch tuned distribution default (§Perf): "2d" = TP+FSDP,
    # "fsdp" = pure DP/FSDP (best when the core op can't split over TP,
    # e.g. rwkv's 40 heads on a 16-way axis, or when activation gathers
    # dominate param sync — small models at large batch)
    sharding_mode: str = "2d"

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch run the long_500k decode shape?"""
        return self.family in ("ssm", "hybrid")

    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            num_layers=max(2, len(self.block_pattern) or 2),
            d_model=64,
            num_heads=min(self.num_heads, 4) if self.num_heads else 0,
            num_kv_heads=min(self.num_kv_heads, 2) if self.num_kv_heads else 0,
            head_dim=16 if self.num_heads else 0,
            d_ff=128,
            vocab_size=256,
            num_experts=min(self.num_experts, 4),
            num_experts_per_tok=min(self.num_experts_per_tok, 2),
            moe_group_size=16,
            num_encoder_layers=2 if self.is_encoder_decoder else 0,
            encoder_seq=16 if self.is_encoder_decoder else 0,
            num_patches=16 if self.family == "vlm" else 0,
            local_window=min(self.local_window, 8) if self.local_window else 0,
            lru_width=64 if self.family == "hybrid" else 0,
            rwkv_head_size=16 if self.family == "ssm" else self.rwkv_head_size,
            rwkv_chunk=8,
            sliding_window=min(self.sliding_window, 8) if self.sliding_window else 0,
            dtype="float32",
            remat=False,
        )

    def param_count(self) -> int:
        """Approximate parameter count (embeddings included once)."""
        d, ff, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.resolved_head_dim
        n_q = self.num_heads * hd
        n_kv = self.num_kv_heads * hd if self.num_kv_heads else 0
        per_attn = d * n_q + 2 * d * n_kv + n_q * d
        per_mlp = 3 * d * ff  # SwiGLU
        if self.family == "moe":
            per_mlp = self.num_experts * 3 * d * ff + d * self.num_experts
        if self.family == "ssm":
            per_layer = 6 * d * d + 2 * d * ff  # rwkv time+channel mix (approx)
        elif self.family == "hybrid":
            pat = self.block_pattern or ("rglru",)
            lru = self.lru_width or d
            rec = 3 * d * lru + self.conv_width * lru
            att = per_attn
            n_rec = sum(1 for b in self.block_pattern for _ in [b] if b == "rglru") or 1
            frac_rec = n_rec / max(len(self.block_pattern), 1)
            per_layer = frac_rec * rec + (1 - frac_rec) * att + 3 * d * ff
        else:
            per_layer = per_attn + per_mlp
        total = self.num_layers * per_layer + v * d * (1 if self.tie_embeddings else 2)
        if self.is_encoder_decoder:
            total += self.num_encoder_layers * (per_attn + 2 * d * ff)
        return int(total)

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: k of E experts active)."""
        if self.family != "moe":
            return self.param_count()
        d, ff, e = self.d_model, self.d_ff, self.num_experts
        k = self.num_experts_per_tok
        expert_params = self.num_layers * e * 3 * d * ff
        active_experts = self.num_layers * k * 3 * d * ff
        return int(self.param_count() - expert_params + active_experts)


REGISTRY: Dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    # import the config modules lazily so REGISTRY is populated
    import repro_torch.configs.all  # noqa: F401

    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(REGISTRY)}")
    return REGISTRY[name]


def all_arch_names():
    import repro_torch.configs.all  # noqa: F401

    return sorted(REGISTRY)
