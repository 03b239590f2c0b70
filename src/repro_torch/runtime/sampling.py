"""Per-slot token sampling for the serving engine.

Port of ``repro.runtime.sampling``. The continuous-batching engine carries
independent requests in batch slots, so randomness is *per slot*: each slot
owns a key derived from ``(seed, slot)``, folded with the engine's step
count, so batch composition never changes a slot's sample stream — the
property the speculative rejection-sampling rule needs to stay
distribution-identical to the verifier, and what makes sampled serving
reproducible under slot churn.

Keys are (B,) int64 tensors holding 32-bit values, and every draw is a
counter-based hash of (key, counter) computed with tensor ops on the
keys' device: no ``torch.Generator`` state, no host round trip, and the
same bits on the CPU and the card. It is NOT JAX's threefry: the port
draws different numbers from the same seed, so sampled streams of the two
packages agree in distribution, not token for token (greedy streams agree
exactly).

``temperature == 0`` is exactly argmax (first maximum on ties); ``top_k``
0 or ``>= vocab`` keeps every token; the padded vocabulary columns never
carry probability mass.
"""
from __future__ import annotations

from typing import Optional

import torch

_M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """32-bit avalanche hash of int64 values in [0, 2^32). Multipliers are
    below 2^31, so no int64 product overflows."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x2C1B3C6D) & _M32
    return x ^ (x >> 16)


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    """Derive new keys from ``keys`` and ``data`` (an int or a tensor that
    broadcasts against ``keys``)."""
    d = torch.as_tensor(data, dtype=torch.int64, device=keys.device) & _M32
    return _mix32((keys ^ _mix32(d ^ _GOLDEN)) & _M32)


def make_slot_keys(seed: int, n_slots: int, device=None) -> torch.Tensor:
    """One key per batch slot: (n_slots,) int64, derived from (seed, slot
    index) so a slot's stream is independent of its neighbours."""
    root = _mix32(torch.tensor(int(seed) & _M32, dtype=torch.int64,
                               device=device))
    return fold_in(root, torch.arange(n_slots, dtype=torch.int64,
                                      device=device))


def fold_step(keys: torch.Tensor, step) -> torch.Tensor:
    """Fold a launch counter into every slot key."""
    return fold_in(keys, step)


def uniform(keys: torch.Tensor, n: Optional[int] = None) -> torch.Tensor:
    """Uniform f32 draws in [0, 1) with 24 random bits: one per key, or
    (B, n) with ``n`` independent draws per key."""
    h = keys if n is None else fold_in(
        keys[:, None], torch.arange(n, dtype=torch.int64, device=keys.device))
    return (_mix32(h) >> 8).to(torch.float32) * (1.0 / 2 ** 24)


def top_k_mask(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Mask all but the k largest logits per row to -inf. ``k = 0`` and
    ``k >= vocab`` keep every logit."""
    if not k or k >= logits.shape[-1]:
        return logits
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits >= kth, logits,
                       torch.full((), float("-inf"), device=logits.device))


def token_dist(logits: torch.Tensor, temperature: float, vocab: int,
               top_k: int = 0) -> torch.Tensor:
    """Sampling distribution over the REAL vocab for (possibly padded)
    logits: (..., Vp) -> f32 probs (..., vocab). At temperature 0 it is the
    one-hot argmax distribution, which makes the rejection-sampling rule
    reduce exactly to greedy acceptance."""
    lg = top_k_mask(logits[..., :vocab].float(), top_k)
    if temperature > 0:
        return torch.softmax(lg / max(float(temperature), 1e-6), dim=-1)
    return torch.nn.functional.one_hot(lg.argmax(-1), vocab).float()


def categorical(keys: torch.Tensor, probs: torch.Tensor) -> torch.Tensor:
    """One draw per row of ``probs`` (B, V) by inverse CDF with the key's
    uniform: (B,) int64. A zero-probability token is never drawn (its CDF
    step is empty and the uniform is below 1)."""
    cdf = torch.cumsum(probs.float(), dim=-1)
    u = uniform(keys)[:, None] * cdf[:, -1:]
    idx = torch.searchsorted(cdf.contiguous(), u.contiguous(), right=True)
    return idx[:, 0].clamp(max=probs.shape[-1] - 1)


def sample_tokens(logits: torch.Tensor, keys: torch.Tensor,
                  temperature: float, vocab: int, top_k: int = 0,
                  salt: Optional[int] = None) -> torch.Tensor:
    """Per-slot categorical sample (greedy at temperature 0).

    logits: (B, Vp); keys: (B,) per-slot keys. Returns (B,) int64 in
    [0, vocab). ``salt`` folds a stream id into the keys so different uses
    of one launch's keys (draft position j, bonus sample) stay disjoint."""
    if temperature <= 0:
        return logits[..., :vocab].argmax(-1)
    if salt is not None:
        keys = fold_in(keys, salt)
    return categorical(keys, token_dist(logits, temperature, vocab, top_k))
