"""RWKV-6 "Finch" 1.6B [arXiv:2404.05892] — attention-free, data-dependent decay.

24L d_model=2048 d_ff=7168 vocab=65536, head size 64 (32 heads).
O(1) decode state -> long_500k RUNS.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="rwkv6-1.6b",
    family="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=32,           # derived: d_model / rwkv_head_dim
    d_ff=7168,
    vocab_size=65536,
    norm="layernorm",
    rwkv_head_dim=64,
    source="arXiv:2404.05892 (Eagle and Finch / RWKV-6)",
)
