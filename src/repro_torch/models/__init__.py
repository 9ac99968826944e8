from .config import ModelConfig, MoEConfig
from .model import (LM, aux_loss_coef, cross_entropy, decode_step, forward_encode, forward_train,
                    init_params, param_count, prefill, train_loss, train_stages)
from .transformer import apply_stack, init_caches, init_stack, segment_specs
