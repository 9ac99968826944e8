from .optimizer import (Optimizer, adamw, clip_by_global_norm, constant_schedule,
                        cosine_schedule, global_norm, linear_warmup_cosine, sgd)
from .train_step import TrainState, make_eval_step, make_train_state, make_train_step
