"""HuBERT-XLarge [arXiv:2106.07447] — audio encoder, same arch as wav2vec2.

48L d_model=1280 16H (GQA kv=16) d_ff=5120 vocab=504 (masked-unit codebook).
Encoder-only: bidirectional attention, no decode shapes (DESIGN.md §4).
The conv feature extractor is a STUB: inputs are precomputed frame features
(B, T, 512) through a linear projection.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5120,
    vocab_size=504,
    activation="gelu",
    norm="layernorm",
    qkv_bias=True,
    encoder_only=True,
    frontend="audio_stub",
    frontend_dim=512,
    tie_embeddings=True,  # unit codebook head shares the (504, d) embedding
    source="arXiv:2106.07447 (HuBERT); backbone per wav2vec2 arXiv:2006.11477",
)
