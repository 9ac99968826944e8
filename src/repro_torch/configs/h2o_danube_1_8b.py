"""H2O-Danube-1.8B [arXiv:2401.16818] — llama+mistral mix with sliding-window.

24L d_model=2560 32H (GQA kv=8) d_ff=6912 vocab=32000, SWA window 4096.
Window cache is O(window) -> long_500k RUNS.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="h2o-danube-1.8b",
    family="dense",
    n_layers=24,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6912,
    vocab_size=32000,
    activation="swiglu",
    sliding_window=4096,
    source="arXiv:2401.16818 (H2O-Danube)",
)
