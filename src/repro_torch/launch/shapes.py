"""Assigned input-shape cells and abstract input specs (the JAX package's
``launch/shapes.py``).

Four shapes per architecture (40 cells):

  train_4k      seq 4,096   global_batch 256   -> train_step
  prefill_32k   seq 32,768  global_batch 32    -> serve prefill
  decode_32k    seq 32,768  global_batch 128   -> serve decode (1 new token)
  long_500k     seq 524,288 global_batch 1     -> decode; SSM/hybrid only

``input_specs`` returns meta tensors (shape and dtype, no data: the
counterpart of ``jax.ShapeDtypeStruct``) for every model input of the
cell — tokens/labels for training, token + cache(+pos) for decode, stub
frame/patch embeddings for audio/vlm.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.models import model as M

META = torch.device("meta")


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524_288, 1, "decode"),
}


def cell_supported(cfg, shape: ShapeCell) -> Optional[str]:
    """None if runnable; else the skip reason (recorded in EXPERIMENTS.md)."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return (
            "full-attention KV cache/scores are quadratic at 524k; "
            "run only for ssm/hybrid (DESIGN.md §6)"
        )
    return None


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def _stub_inputs(cfg, batch: int) -> Dict[str, torch.Tensor]:
    out = {}
    if cfg.family == "audio":
        out["frames"] = _spec((batch, cfg.encoder_seq, cfg.d_model), torch.float32)
    if cfg.family == "vlm":
        out["patches"] = _spec((batch, cfg.num_patches, cfg.d_model), torch.float32)
    return out


def train_input_specs(cfg, shape: ShapeCell) -> Dict[str, torch.Tensor]:
    b, s = shape.global_batch, shape.seq_len
    return {
        "tokens": _spec((b, s), torch.int32),
        "labels": _spec((b, s), torch.int32),
        **_stub_inputs(cfg, b),
    }


def prefill_input_specs(cfg, shape: ShapeCell) -> Dict[str, torch.Tensor]:
    b, s = shape.global_batch, shape.seq_len
    return {
        "tokens": _spec((b, s), torch.int32),
        **_stub_inputs(cfg, b),
    }


def abstract_cache(cfg, shape: ShapeCell):
    """The serve cache (KV at seq_len) as meta tensors."""
    return M.make_serve_cache(cfg, shape.global_batch, shape.seq_len, device=META)


def decode_input_specs(cfg, shape: ShapeCell):
    """(token, cache, pos) abstract inputs for one decode step.  ``pos`` is
    a Python int, ``seq_len - 1`` (the cache full): the port's decode reads
    the position on the host (the key cut, the cache slot), so it cannot
    take the reference's abstract int32 scalar."""
    b = shape.global_batch
    return {
        "token": _spec((b, 1), torch.int32),
        "cache": abstract_cache(cfg, shape),
        "pos": shape.seq_len - 1,
    }


def input_specs(cfg, shape: ShapeCell):
    if shape.kind == "train":
        return train_input_specs(cfg, shape)
    if shape.kind == "prefill":
        return prefill_input_specs(cfg, shape)
    return decode_input_specs(cfg, shape)
