"""Plain PyTorch oracles for the kernels of this slice.

Port of ``repro.kernels.ref``, plus ``ssd_reference``, the model-layout
sequential scan of ``repro.models.ssm``. ``flash_attention_ref`` arrives
with the slice that ports its kernel.
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


def ssd_scan_ref(x, dt, A, B, C):
    """Sequential SSD oracle. x: (BH, S, hp); dt: (BH, S); A: (BH,);
    B, C: (BH, S, n). Returns (y in x's dtype, final state (BH, hp, n)
    f32)."""
    BH, S, hp = x.shape
    xf, dtf, Bf, Cf = x.float(), dt.float(), B.float(), C.float()
    a = A.float()
    state = torch.zeros((BH, hp, B.shape[-1]), dtype=torch.float32,
                        device=x.device)
    ys = []
    for t in range(S):
        decay = torch.exp(dtf[:, t] * a)  # (BH,)
        state = (state * decay[:, None, None]
                 + (xf[:, t] * dtf[:, t, None])[:, :, None] * Bf[:, t, None, :])
        ys.append(torch.einsum("bpn,bn->bp", state, Cf[:, t]))
    return torch.stack(ys, dim=1).to(x.dtype), state


def ssd_reference(x, dt, A, B_, C_):
    """O(s) sequential reference. Same signature and returns as
    ``ssd_chunked``."""
    b, s, h, p = x.shape
    g, n = B_.shape[2], B_.shape[3]
    rep = h // g
    Bh = B_.repeat_interleave(rep, dim=2)
    Ch = C_.repeat_interleave(rep, dim=2)
    state = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(s):
        decay = torch.exp(dt[:, t] * A)  # (b,h)
        upd = torch.einsum("bhp,bhn->bhpn", x[:, t] * dt[:, t, :, None],
                           Bh[:, t])
        state = state * decay[..., None, None] + upd
        ys.append(torch.einsum("bhpn,bhn->bhp", state, Ch[:, t]))
    return torch.stack(ys, dim=1), state
