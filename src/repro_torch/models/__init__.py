from .config import ModelConfig, MoEConfig
from .model import (LM, cross_entropy, decode_step, forward_encode, forward_train, init_params,
                    param_count, prefill)
from .transformer import apply_stack, init_caches, init_stack, segment_specs
