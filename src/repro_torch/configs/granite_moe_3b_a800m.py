"""Granite-MoE 3B-a800m [hf:ibm-granite/granite-3.0-1b-a400m-base family].

32L d_model=1536 24H (GQA kv=8) d_ff=512 (per expert) vocab=49155,
MoE 40 experts top-8 (the assignment also says "32 experts"; we follow the
primary "MoE 40e top-8" spec — discrepancy noted in DESIGN.md §4).
"""
from ..models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    activation="swiglu",
    tie_embeddings=True,
    moe=MoEConfig(
        n_experts=40,
        top_k=8,
        d_expert=512,
        n_shared=0,
        capacity_factor=1.25,
        group_size=256,
        aux_loss_coef=0.01,
    ),
    source="hf:ibm-granite/granite-3.0-3b-a800m-base (family per 1b-a400m card)",
)
