"""Model configuration — one dataclass covering all six assigned families.

Families: dense decoder (llama/gemma/qwen-style), fine-grained MoE, RWKV-6
(attention-free SSM), RecurrentGemma hybrid (RG-LRU + local attention), audio
encoder (HuBERT backbone, stub conv frontend) and VLM (PaliGemma backbone,
stub SigLIP frontend).

A copy of ``repro.models.config``, field for field and with the same
defaults, so that the port never imports the JAX package.  ``attn_impl``
keeps the JAX value set: in the port ``"pallas"`` selects the CUDA
flash-attention kernel (``repro_torch.kernels.ops.flash_attention``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

__all__ = ["MoEConfig", "ModelConfig"]


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int                 # hidden size of each routed expert
    n_shared: int = 0             # always-on shared experts (DeepSeek-MoE)
    capacity_factor: float = 1.25
    group_size: int = 256         # tokens per dispatch group (GShard-style)
    aux_loss_coef: float = 0.01
    router_dtype: str = "float32"
    impl: str = "einsum"          # einsum (GShard one-hot) | scatter (sort-based)


@dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                   # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    d_ff: int
    vocab_size: int
    n_kv_heads: Optional[int] = None      # GQA; None -> n_heads; 1 -> MQA
    head_dim: Optional[int] = None        # None -> d_model // n_heads
    activation: str = "swiglu"            # swiglu | geglu | gelu
    norm: str = "rmsnorm"                 # rmsnorm | layernorm
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    sliding_window: Optional[int] = None  # SWA width (h2o-danube, rg local attn)
    encoder_only: bool = False            # hubert: bidirectional, no decode
    logit_softcap: Optional[float] = None
    embedding_scale: bool = False         # gemma multiplies embeds by sqrt(d)
    moe: Optional[MoEConfig] = None
    # -- hybrid (recurrentgemma) ------------------------------------------------
    block_pattern: Optional[Tuple[str, ...]] = None  # e.g. ("rglru","rglru","local_attn")
    rglru_d_rnn: Optional[int] = None     # RG-LRU recurrence width (None -> d_model)
    conv1d_width: int = 4
    # -- rwkv6 -------------------------------------------------------------------
    rwkv_head_dim: int = 64
    rwkv_chunk: int = 32                  # chunked-WKV block length (L)
    # -- modality frontends (STUBS: precomputed embeddings are the input) -------
    frontend: Optional[str] = None        # None | audio_stub | vision_stub
    frontend_dim: int = 512               # conv-feature / projected-patch width
    n_prefix_embeds: int = 256            # VLM: image patches per sequence
    # -- numerics ------------------------------------------------------------------
    param_dtype: str = "float32"
    activation_dtype: str = "float32"
    remat: bool = False                   # per-layer activation checkpointing
    train_microbatch: int = 1             # gradient-accumulation slices per step
    padded_vocab: Optional[int] = None    # pad embed/head to a shardable size
    opt_moment_dtype: str = "float32"     # AdamW m/v dtype (bf16 halves opt state)
    attn_impl: str = "auto"               # auto | naive | chunked | pallas
    attn_chunk: int = 512                 # q-block for chunked attention
    kernel_impl: str = "jnp"              # jnp | pallas: RWKV6/RG-LRU scans, MoE router
    scan_layers: bool = True              # lax.scan over (stacked) layer params
    source: str = ""                      # citation (paper / model card)

    # -- derived -----------------------------------------------------------------
    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads if self.n_kv_heads is not None else self.n_heads

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_decode(self) -> bool:
        return not self.encoder_only

    @property
    def supports_long_context(self) -> bool:
        """True if decode state is O(1)/O(window) in sequence length."""
        return self.family in ("ssm", "hybrid") or self.sliding_window is not None

    def pattern_for_layers(self) -> List[str]:
        """Resolved per-layer block type list of length n_layers."""
        if self.family == "ssm":
            return ["rwkv6"] * self.n_layers
        if self.block_pattern:
            pat = list(self.block_pattern)
            return [pat[i % len(pat)] for i in range(self.n_layers)]
        return ["attention"] * self.n_layers

    def validate(self) -> "ModelConfig":
        if self.family not in ("dense", "moe", "ssm", "hybrid", "audio", "vlm"):
            raise ValueError(f"unknown family {self.family!r}")
        if self.family == "moe" and self.moe is None:
            raise ValueError("moe family requires moe config")
        if self.n_heads and self.kv_heads and self.n_heads % self.kv_heads != 0:
            raise ValueError(f"n_heads={self.n_heads} not divisible by kv={self.kv_heads}")
        if self.family == "hybrid" and not self.block_pattern:
            raise ValueError("hybrid family requires block_pattern")
        if self.encoder_only and self.family not in ("audio", "dense"):
            raise ValueError("encoder_only supported for audio/dense")
        return self

    def reduced(self, n_layers: int = 2, d_model: int = 256, n_experts: int = 4,
                vocab: int = 512) -> "ModelConfig":
        """Smoke-test variant of the same family (small dims, same topology)."""
        d_model = min(d_model, self.d_model)
        n_heads = max(1, min(self.n_heads, d_model // 64))
        kv = max(1, min(self.kv_heads, n_heads))
        while n_heads % kv:
            kv -= 1
        changes = dict(
            n_layers=n_layers,
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=kv,
            head_dim=64 if self.head_dim else None,
            d_ff=max(64, d_model * 2),
            vocab_size=min(vocab, self.vocab_size),
            rglru_d_rnn=d_model if self.rglru_d_rnn else None,
            frontend_dim=min(self.frontend_dim, 64),
            n_prefix_embeds=min(self.n_prefix_embeds, 8),
            remat=False,
        )
        if self.moe:
            changes["moe"] = dataclasses.replace(
                self.moe,
                n_experts=min(n_experts, self.moe.n_experts),
                top_k=min(self.moe.top_k, min(n_experts, self.moe.n_experts)),
                d_expert=64,
                group_size=32,
            )
        if self.block_pattern and n_layers < len(self.block_pattern):
            changes["n_layers"] = len(self.block_pattern)
        return dataclasses.replace(self, **changes).validate()
