from repro_torch.models.model import (
    adopt_cache_slot,
    decode_step,
    init_decode_cache,
    init_params,
    prefill,
    reset_cache_slot,
    reset_cache_slots,
)

__all__ = [
    "adopt_cache_slot",
    "decode_step",
    "init_decode_cache",
    "init_params",
    "prefill",
    "reset_cache_slot",
    "reset_cache_slots",
]
