"""RecurrentGemma-9B [arXiv:2402.19427 Griffin; model arXiv:2404.07839].

38L d_model=4096 16H (MQA kv=1) d_ff=12288 vocab=256000; RG-LRU + local
attention in a 2-recurrent:1-attention pattern, window 2048.
Sub-quadratic decode state -> long_500k RUNS.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    activation="geglu",
    embedding_scale=True,
    tie_embeddings=True,
    block_pattern=("rglru", "rglru", "local_attn"),
    sliding_window=2048,
    rglru_d_rnn=4096,
    conv1d_width=4,
    remat=True,
    train_microbatch=4,
    source="arXiv:2402.19427 (Griffin) / arXiv:2404.07839 (RecurrentGemma)",
)
