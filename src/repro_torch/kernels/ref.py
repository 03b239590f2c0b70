"""Plain PyTorch oracles for the kernels of this slice.

Port of ``repro.kernels.ref``, plus ``ssd_reference``, the model-layout
sequential scan of ``repro.models.ssm``, and ``flash_decode_ref``, the
oracle that ``repro.kernels.flash_decode`` keeps beside its kernel.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


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


def flash_attention_ref(q, k, v, *, group: int = 1, causal: bool = True,
                        window: int = 0):
    """q: (BH, Sq, hd); k, v: (BKV, Sk, hd) with BH = BKV * group. One
    softmax in f32 with the additive -1e30 mask; out in q's dtype."""
    Sq, hd = q.shape[1], q.shape[2]
    Sk = k.shape[1]
    kf = k.float().repeat_interleave(group, dim=0)
    vf = v.float().repeat_interleave(group, dim=0)
    s = torch.einsum("bqh,bsh->bqs", q.float(), kf) / math.sqrt(hd)
    rows = torch.arange(Sq, device=q.device)[:, None]
    cols = torch.arange(Sk, device=q.device)[None, :]
    bad = torch.zeros((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        bad = bad | (cols > rows)
    if window > 0:
        bad = bad | (cols <= rows - window)
    w = torch.softmax(s + torch.where(bad, NEG_INF, 0.0), dim=-1)
    return torch.einsum("bqs,bsh->bqh", w, vf).to(q.dtype)


def flash_decode_ref(q, k, v, kv_len, k_scale=None, v_scale=None, *,
                     group: int = 1):
    """q: (BH, hd); k, v: (BKV, S, hd) float or int8 with scales (BKV, S,
    1). One softmax over the positions < ``kv_len``; out in q's dtype.
    With ``kv_len`` = 0 every column is masked alike and this returns the
    mean of v (the kernel returns zeros)."""
    kf, vf = k.float(), v.float()
    if k.dtype == torch.int8:
        kf = kf * k_scale.float()
        vf = vf * v_scale.float()
    kf = kf.repeat_interleave(group, dim=0)
    vf = vf.repeat_interleave(group, dim=0)
    s = torch.einsum("bh,bsh->bs", q.float(), kf) / math.sqrt(q.shape[-1])
    n = torch.as_tensor(kv_len, device=q.device).reshape(())
    live = torch.arange(k.shape[1], device=q.device)[None, :] < n
    w = torch.softmax(torch.where(live, s, NEG_INF), dim=-1)
    return torch.einsum("bs,bsh->bh", w, vf).to(q.dtype)


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
