from repro_torch.optim.optimizer import (
    OptimizerConfig,
    OptState,
    apply_updates,
    clip_by_global_norm,
    global_norm,
    grads_of,
    init_opt_state,
    opt_state_bytes,
    trainable,
)
from repro_torch.optim.schedule import constant, distillcycle_decay, warmup_cosine

__all__ = [
    "OptimizerConfig",
    "OptState",
    "apply_updates",
    "clip_by_global_norm",
    "global_norm",
    "grads_of",
    "init_opt_state",
    "opt_state_bytes",
    "trainable",
    "constant",
    "distillcycle_decay",
    "warmup_cosine",
]
