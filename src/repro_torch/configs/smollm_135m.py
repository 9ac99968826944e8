"""SmolLM-135M [hf:HuggingFaceTB/SmolLM-135M] — small llama-arch dense.

30L d_model=576 9H (GQA kv=3) d_ff=1536 vocab=49152.
The Tune-representative case: many parallel trials fit one pod.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="smollm-135m",
    family="dense",
    n_layers=30,
    d_model=576,
    n_heads=9,
    n_kv_heads=3,
    d_ff=1536,
    vocab_size=49152,
    activation="swiglu",
    tie_embeddings=True,
    source="hf:HuggingFaceTB/SmolLM-135M",
)
