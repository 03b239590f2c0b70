"""fused_decode — one attention layer of one-token decode in hand-written kernels.

Port of ``repro.kernels.fused_decode``: width-gated QKV projection -> RoPE ->
(int8 absmax round trip of the new K/V) -> online-softmax decode over the
cache with the new token as an extension column -> width-gated output
projection. Same contract as ``layers.mha_decode`` (self-attention branch):
returns ``(out (B, 1, d), cache)``. Where JAX returns a new cache, this
writes the new token's K/V (and scales) into ``cache`` in place, after the
attention has read it.

The projections run in f32 from the f32 master weights, as the TPU kernel
does (``fused_decode.py:393-409``). With bf16 activations that differs from
the unfused path (which rounds the weights to bf16), so the plain version
here mirrors the kernel, not the unfused op sequence. The two agree in the
f32 configs the CPU tests use.

On a CPU tensor ``fused_decode_step`` runs ``fused_decode_plain``. On CUDA
tensors it issues three launches (design in ``csrc/fused_decode.cu``): the
QKV projection kernel, the attention kernel, and the morph_matmul kernel for
the output projection with ``active_k = a_q``. ``launch_count()`` counts
fused_decode_step calls that launched them. Dense caches enter the attention
kernel as a pool of one page per slot (page = slot, table = arange(B)), so
any capacity works; paged caches arrive with the paged slice.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import morph_matmul as _mm

KERNEL_NEG_INF = -1e30  # running-max init (flash_decode convention)

_LAUNCHES = {"n": 0}
_TABLES: Dict[tuple, torch.Tensor] = {}
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_CACHE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_CHUNK = 64  # cache rows the attention kernel stages at once (kChunk)


def launch_count() -> int:
    """fused_decode_step calls that launched the kernels (3 launches each)."""
    return _LAUNCHES["n"]


def reset_launch_count() -> None:
    _LAUNCHES["n"] = 0


def _gates(active, B: int, device):
    """(a_q, a_kv) as (B,) int32 tensors, or None for full width."""
    out = []
    for name in ("q_dim", "kv_dim"):
        a = active.get(name) if active else None
        if a is not None:
            a = torch.as_tensor(a, dtype=torch.int32, device=device)
            a = a.expand(B).contiguous() if a.dim() == 0 else a
        out.append(a)
    return out


def _slot_kpos(pos: torch.Tensor, S: int, window: int):
    """Write slot of the new token, and the absolute position of every cache
    column with the slot column (stale until the write) masked to -1e9."""
    B = pos.shape[0]
    idx = torch.arange(S, device=pos.device)[None, :]
    pb = pos.long()[:, None]
    if window:
        slot = torch.remainder(pos.long(), S)
        wraps = torch.where(idx <= torch.remainder(pb, S), 0, 1)
        kpos = (torch.div(pb, S, rounding_mode="floor") - wraps) * S + idx
        kpos = torch.where(kpos < 0, -10**9, kpos)
    else:
        slot = torch.clamp(pos.long(), max=S - 1)
        kpos = torch.where(idx <= pb, idx, -10**9)
    kpos = kpos.clone()
    kpos[torch.arange(B, device=pos.device), slot] = -10**9
    return slot, kpos


def _rope_rows(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """RoPE on f32 rows. x: (B, n, hd); positions: (B,)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = torch.exp(-torch.arange(half, dtype=torch.float32, device=x.device)
                      * (math.log(theta) / half))
    ang = positions.float()[:, None, None] * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def fused_decode_plain(params, x, cache, pos, cfg, a_q=None, a_kv=None):
    """Plain PyTorch mirror of the kernels (f32 math, one softmax pass)."""
    dt = x.dtype
    B = x.shape[0]
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    G = H // KV
    dev = x.device
    pos = torch.as_tensor(pos, dtype=torch.int32, device=dev).expand(B)
    xf = x[:, 0].float()

    def proj(w, a):
        y = xf @ w.float()
        if a is not None:
            cols = torch.arange(y.shape[-1], device=dev)[None, :]
            y = torch.where(cols < a[:, None], y, torch.zeros((), device=dev))
        return y

    q = proj(params["wq"], a_q).view(B, H, hd)
    kn = proj(params["wk"], a_kv).view(B, KV, hd)
    vn = proj(params["wv"], a_kv).view(B, KV, hd)
    if cfg.use_rope:
        q = _rope_rows(q, pos, cfg.rope_theta)
        kn = _rope_rows(kn, pos, cfg.rope_theta)
    quant = bool(cfg.kv_quant)
    if quant:
        ksc = kn.abs().amax(-1, keepdim=True) / 127.0
        vsc = vn.abs().amax(-1, keepdim=True) / 127.0
        kq = torch.round(kn / torch.clamp(ksc, min=1e-8))
        vq = torch.round(vn / torch.clamp(vsc, min=1e-8))
        k_st, v_st = kq.to(torch.int8), vq.to(torch.int8)
        ks_st, vs_st = ksc.to(torch.bfloat16), vsc.to(torch.bfloat16)
        ke, ve = kq * ks_st.float(), vq * vs_st.float()
        kc = cache["k"].float() * cache["k_scale"].float()
        vc = cache["v"].float() * cache["v_scale"].float()
    else:
        k_st, v_st = kn.to(cache["k"].dtype), vn.to(cache["v"].dtype)
        ke, ve = k_st.float(), v_st.float()
        kc, vc = cache["k"].float(), cache["v"].float()
    S = cache["k"].shape[1]
    window = cfg.sliding_window
    slot, kpos = _slot_kpos(pos, S, window)
    p = pos.long()[:, None]
    valid = (kpos >= 0) & (kpos <= p)
    if window:
        valid = valid & (kpos > p - window)
    scale = 1.0 / math.sqrt(hd)
    qg = q.view(B, KV, G, hd)
    s = torch.einsum("bkgd,bskd->bkgs", qg, kc) * scale
    vmask = valid[:, None, None, :]
    s = torch.where(vmask, s, torch.full((), KERNEL_NEG_INF, device=dev))
    s_e = torch.einsum("bkgd,bkd->bkg", qg, ke)[..., None] * scale
    m = torch.maximum(s.amax(-1, keepdim=True), s_e)
    pr = torch.where(vmask, torch.exp(s - m), torch.zeros((), device=dev))
    pe = torch.exp(s_e - m)
    l = pr.sum(-1, keepdim=True) + pe
    o = torch.einsum("bkgs,bskd->bkgd", pr, vc) + pe * ve[:, :, None, :]
    o = (o / torch.clamp(l, min=1e-20)).reshape(B, H * hd)
    if a_q is not None:
        cols = torch.arange(H * hd, device=dev)[None, :]
        o = torch.where(cols < a_q[:, None], o, torch.zeros((), device=dev))
    out = (o @ params["wo"].float()).to(dt)[:, None, :]
    bix = torch.arange(B, device=dev)
    cache["k"][bix, slot] = k_st
    cache["v"][bix, slot] = v_st
    if quant:
        cache["k_scale"][bix, slot] = ks_st
        cache["v_scale"][bix, slot] = vs_st
    return out, cache


def _lib():
    lib = _build.load("fused_decode")
    qkv, attn = lib.fused_qkv_launch, lib.fused_attn_launch
    if qkv.argtypes is None:
        qkv.argtypes = [_P, _I, _P, _P, _P, _I, _P, _P, _P, _P, _P,
                        _I, _I, _I, _I, _I, _I, _I, _P, _P, _P]
        qkv.restype = _I
        attn.argtypes = [_P, _P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P,
                         _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _P]
        attn.restype = _I
    return qkv, attn


def _attn_plan(heads: int, S: int):
    """(splits, rows per split) of the cache rows for ``heads`` (slot, KV
    head) pairs: enough blocks to fill the card, whole 64-row chunks."""
    chunks = max(1, -(-S // _CHUNK))
    s = max(1, min(chunks, -(-_mm._TARGET_BLOCKS // heads)))
    per = -(-chunks // s)
    return -(-chunks // per), per * _CHUNK


def _identity_table(B: int, device) -> torch.Tensor:
    key = (B, str(device))
    t = _TABLES.get(key)
    if t is None:
        t = torch.arange(B, dtype=torch.int32, device=device)[:, None]
        _TABLES[key] = t
    return t


def _fused_decode_cuda(params, x, cache, pos, cfg, a_q, a_kv):
    dev = x.device
    B, _, dm = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    wq, wk, wv, wo = params["wq"], params["wk"], params["wv"], params["wo"]
    for name, t in (("x", x), ("wq", wq), ("wk", wk), ("wv", wv), ("wo", wo)):
        _mm._check(t, name, dev)
    if not (wq.dtype == wk.dtype == wv.dtype):
        raise TypeError("wq, wk and wv must share one dtype")
    kc, vc = cache["k"], cache["v"]
    S = kc.shape[1]
    if tuple(kc.shape) != (B, S, KV, hd) or kc.shape != vc.shape:
        raise ValueError(f"dense cache must be (B, S, KV, hd) = "
                         f"{(B, S, KV, hd)}, got {tuple(kc.shape)}")
    quant = bool(cfg.kv_quant)
    for name, t in (("k", kc), ("v", vc)):
        _mm._check(t, f"cache {name}", dev, tuple(_CACHE_CODE))
    if (kc.dtype == torch.int8) != quant or vc.dtype != kc.dtype:
        raise TypeError(f"cache dtype {kc.dtype} does not match "
                        f"kv_quant={quant}")
    if quant:
        ks, vs = cache["k_scale"], cache["v_scale"]
        for name, t in (("k_scale", ks), ("v_scale", vs)):
            _mm._check(t, name, dev, (torch.bfloat16,))
        ks_p, vs_p = ks.data_ptr(), vs.data_ptr()
    else:
        ks_p = vs_p = None
    if pos.dim() == 0:
        pos = pos.expand(B)
    pos = pos.contiguous()
    _mm._check(pos, "pos", dev, (torch.int32,))
    stream = torch.cuda.current_stream(dev).cuda_stream
    qkv_fn, attn_fn = _lib()
    qd, kvd = H * hd, KV * hd
    q = torch.empty((B, qd), dtype=torch.float32, device=dev)
    k = torch.empty((B, kvd), dtype=torch.float32, device=dev)
    v = torch.empty((B, kvd), dtype=torch.float32, device=dev)
    align = 16 if wq.dtype == torch.float32 else 8
    vec = (qd % 4 == 0 and kvd % 4 == 0
           and all(w.data_ptr() % align == 0 for w in (wq, wk, wv)))
    splits, kps, ws, tickets = _mm.plan([qd, kvd, kvd], dm, B, dev)
    err = qkv_fn(x.data_ptr(), _mm._DTYPE_CODE[x.dtype], wq.data_ptr(),
                 wk.data_ptr(), wv.data_ptr(), _mm._DTYPE_CODE[wq.dtype],
                 q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 _mm._gate_ptr(a_q, B, dev), _mm._gate_ptr(a_kv, B, dev),
                 B, dm, qd, kvd, int(vec), splits, kps, _mm._ptr(ws),
                 _mm._ptr(tickets), stream)
    if err != 0:
        raise RuntimeError(f"fused QKV kernel launch failed: CUDA error {err}")
    att = torch.empty((B, qd), dtype=torch.float32, device=dev)
    rope_coef = float(np.float32(math.log(cfg.rope_theta) / (hd // 2)))
    splits, rows = _attn_plan(B * KV, S)
    G = H // KV
    ws_a = torch.empty(B * KV * splits * (2 * G + G * hd), dtype=torch.float32,
                       device=dev)
    err = attn_fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), kc.data_ptr(),
                  vc.data_ptr(), ks_p, vs_p, _CACHE_CODE[kc.dtype],
                  _identity_table(B, dev).data_ptr(), pos.data_ptr(),
                  att.data_ptr(), ws_a.data_ptr(),
                  _mm._tickets(B * KV, dev).data_ptr(), B, H, KV, hd, 1, S,
                  int(cfg.sliding_window), int(bool(cfg.use_rope)), splits,
                  rows, rope_coef, 1.0 / math.sqrt(hd), stream)
    if err != 0:
        raise RuntimeError(f"fused attention kernel launch failed: "
                           f"CUDA error {err}")
    out = torch.empty((B, 1, wo.shape[1]), dtype=x.dtype, device=dev)
    _mm.launch(att.view(B, 1, qd), wo, out, None, a_q, round_w=False)
    return out, cache


def fused_decode_step(params, x, cache, pos, cfg, *, active=None, pages=None,
                      page_size=0):
    """Fused one-token decode of one attention layer: (out (B,1,d), cache),
    with ``cache`` updated in place. ``pos``: (B,) int32 per-slot positions
    (or a scalar shared by every slot)."""
    if pages is not None:
        raise NotImplementedError("paged KV caches arrive with the paged "
                                  "slice of the port")
    B = x.shape[0]
    a_q, a_kv = _gates(active, B, x.device)
    if x.device.type == "cpu":
        return fused_decode_plain(params, x, cache, pos, cfg, a_q, a_kv)
    pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device)
    out = _fused_decode_cuda(params, x.contiguous(), cache, pos, cfg, a_q,
                             a_kv)
    _LAUNCHES["n"] += 1
    return out


def fused_verify(*args, **kwargs):
    """Multi-position verify superkernel: arrives with the speculative slice
    (``repro.kernels.fused_decode.fused_verify`` is its reference)."""
    raise NotImplementedError("fused_verify arrives with the speculative "
                              "slice of the port")
