"""PaliGemma-3B [arXiv:2407.07726] — VLM: SigLIP vision + gemma decoder.

Language backbone: 18L d_model=2048 8H (MQA kv=1) d_ff=16384 vocab=257216.
The SigLIP encoder + projector is a STUB: inputs are precomputed patch
embeddings (B, 256, 1152) through the linear projector (prefix-LM layout).
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="paligemma-3b",
    family="vlm",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=257216,
    activation="geglu",
    embedding_scale=True,
    tie_embeddings=True,
    frontend="vision_stub",
    frontend_dim=1152,        # SigLIP-So400m width
    n_prefix_embeds=256,      # 224px / 14px patches = 16x16
    source="arXiv:2407.07726 (PaliGemma); decoder per arXiv:2403.08295 (Gemma)",
)
