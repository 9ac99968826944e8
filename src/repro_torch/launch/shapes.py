"""Assigned input shapes and per-(arch, shape) input specs.

Counterpart of ``repro.launch.shapes``.  ``input_specs`` returns tensors on
the meta device as stand-ins for every model input, where JAX returns
``ShapeDtypeStruct``s: the dry-run counts a step on them (shardable, no
allocation), with JAX's shapes and dtypes.

Applicability (DESIGN.md §4):
  - encoder-only archs (hubert) have no decode step -> decode shapes skipped;
    its ``prefill_32k`` is the encoder forward.
  - ``long_500k`` requires sub-quadratic decode state: SSM / hybrid / SWA only.

What differs from the original: a decode step's ``pos`` is a Python int, as
the port's ``decode_step`` takes it, where JAX's is a ``()`` int32 struct;
its caches are ``models.transformer.init_caches(cfg, B, S, "meta")``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch

from ..models import ModelConfig
from ..models import transformer as T

__all__ = ["ShapeSpec", "SHAPES", "applicable", "skip_reason", "input_specs",
           "dryrun_config"]


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str        # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}


def skip_reason(cfg: ModelConfig, shape: ShapeSpec) -> Optional[str]:
    if shape.kind == "decode":
        if not cfg.supports_decode:
            return "encoder-only: no autoregressive decode"
        if shape.seq_len > 100_000 and not cfg.supports_long_context:
            return "full attention without sub-quadratic variant: long-context skipped"
    return None


def applicable(cfg: ModelConfig, shape: ShapeSpec) -> bool:
    return skip_reason(cfg, shape) is None


def dryrun_config(cfg: ModelConfig) -> ModelConfig:
    """bf16 params/activations, chunked attention, per-layer remat.

    remat=True for every arch at production sequence lengths: per-layer
    activation checkpointing is the standard 4k-training memory policy (the
    §Perf log quantifies its compute-vs-memory trade)."""
    return dataclasses.replace(
        cfg, param_dtype="bfloat16", activation_dtype="bfloat16",
        attn_impl="auto", remat=True)


def _meta(shape, dtype: str) -> torch.Tensor:
    return torch.empty(shape, dtype=getattr(torch, dtype), device="meta")


def _batch_structs(cfg: ModelConfig, B: int, S: int, with_labels: bool) -> Dict[str, Any]:
    adt = cfg.activation_dtype
    if cfg.frontend == "audio_stub":
        batch = {"features": _meta((B, S, cfg.frontend_dim), adt)}
        if with_labels:
            batch["labels"] = _meta((B, S), "int32")
        return batch
    if cfg.frontend == "vision_stub":
        P_ = cfg.n_prefix_embeds
        text = S - P_
        batch = {
            "patch_embeds": _meta((B, P_, cfg.frontend_dim), adt),
            "tokens": _meta((B, text), "int32"),
        }
        if with_labels:
            batch["labels"] = _meta((B, text), "int32")
        return batch
    batch = {"tokens": _meta((B, S), "int32")}
    if with_labels:
        batch["labels"] = _meta((B, S), "int32")
    return batch


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, Any]:
    """Meta-device inputs for the counted step of ``shape.kind``.

    train   -> {"batch": ...}                       (state built separately)
    prefill -> {"batch": ...}
    decode  -> {"caches": ..., "tokens": (B,), "pos": int}
    """
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        return {"batch": _batch_structs(cfg, B, S, with_labels=True)}
    if shape.kind == "prefill":
        return {"batch": _batch_structs(cfg, B, S, with_labels=False)}
    return {
        "caches": T.init_caches(cfg, B, S, "meta"),
        "tokens": _meta((B,), "int32"),
        "pos": 0,
    }
