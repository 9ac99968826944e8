"""Gemma-2B [arXiv:2403.08295] — dense, GeGLU, MQA, head_dim=256.

18L d_model=2048 8H (MQA kv=1) d_ff=16384 vocab=256000.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="gemma-2b",
    family="dense",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=256000,
    activation="geglu",
    embedding_scale=True,
    tie_embeddings=True,
    source="arXiv:2403.08295 (Gemma)",
)
