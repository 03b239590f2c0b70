"""Plain PyTorch oracles for the kernels of this slice.

Port of ``repro.kernels.ref``. ``flash_attention_ref`` and ``ssd_scan_ref``
arrive with the slices that port their kernels.
"""
from __future__ import annotations

import torch


def _per_batch(a) -> bool:
    # sized sequence or >=1-d tensor (0-d tensors are scalars)
    return a is not None and (isinstance(a, (list, tuple))
                              or getattr(a, "dim", lambda: 0)() >= 1)


def morph_matmul_ref(x, w, active_n=None, active_k=None):
    """Zero-filled beyond active_n; contraction truncated at active_k.

    ``active_n`` / ``active_k`` may be per-batch sequences (len B) when x is
    (B, M, K): each batch row is sliced at its own active widths."""
    K = x.shape[-1]
    N = w.shape[-1]
    if x.dim() == 3 and (_per_batch(active_n) or _per_batch(active_k)):
        B = x.shape[0]
        ans = list(active_n) if _per_batch(active_n) else [active_n] * B
        aks = list(active_k) if _per_batch(active_k) else [active_k] * B
        return torch.stack([morph_matmul_ref(x[b], w, ans[b], aks[b])
                            for b in range(B)])
    an = N if active_n is None else int(active_n)
    ak = K if active_k is None else int(active_k)
    y = torch.einsum("...mk,kn->...mn", x[..., :, :ak].float(),
                     w[:ak, :an].float())
    y = torch.nn.functional.pad(y, (0, N - an))
    return y.to(x.dtype)
