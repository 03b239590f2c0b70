from repro_torch.models.model import (
    adopt_cache_slot,
    commit_verify,
    decode_step,
    init_decode_cache,
    init_params,
    prefill,
    reset_cache_slot,
    reset_cache_slots,
    verify_step,
)

__all__ = [
    "adopt_cache_slot",
    "commit_verify",
    "decode_step",
    "init_decode_cache",
    "init_params",
    "prefill",
    "reset_cache_slot",
    "reset_cache_slots",
    "verify_step",
]
