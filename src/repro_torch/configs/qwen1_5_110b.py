"""Qwen1.5-110B [hf:Qwen/Qwen1.5-0.5B family card] — dense, QKV bias.

80L d_model=8192 64H (GQA kv=8) d_ff=49152 vocab=152064.
The memory-pressure stress case: FSDP+TP with remat.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen1.5-110b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=49152,
    vocab_size=152064,
    activation="swiglu",
    qkv_bias=True,
    rope_theta=1e6,
    remat=True,
    train_microbatch=8,  # 256-seq global batch -> 32-seq microbatches
    source="hf:Qwen/Qwen1.5-110B (family per hf:Qwen/Qwen1.5-0.5B)",
)
