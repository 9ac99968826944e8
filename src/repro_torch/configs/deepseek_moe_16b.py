"""DeepSeek-MoE 16B [arXiv:2401.06066] — fine-grained MoE.

28L d_model=2048 16H (GQA kv=16) d_ff=1408 (per expert) vocab=102400,
64 routed experts top-6 + 2 shared experts.
"""
from ..models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=102400,
    activation="swiglu",
    moe=MoEConfig(
        n_experts=64,
        top_k=6,
        d_expert=1408,
        n_shared=2,
        capacity_factor=1.25,
        group_size=256,
        aux_loss_coef=0.001,
    ),
    remat=True,
    train_microbatch=2,
    source="arXiv:2401.06066 (DeepSeekMoE)",
)
