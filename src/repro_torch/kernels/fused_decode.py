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
fused_decode_step calls that launched them. The attention kernel is the
decode-attention core shared with ``flash_decode`` (``csrc/decode_attn.cuh``,
split plan in ``decode_attn``): bf16 and int8 caches on the tensor cores
(route ``"tc"``), f32 caches on f32 FMAs (route ``"fma"``), counted by
``route_counts()`` from the route the kernel reports it launched. It reads
the dense (B, S, KV, hd) cache in place, so any capacity works, or a page
pool (n_pages, page_size, KV, hd) through a (B, P) int32 page table
(``pages``, the TPU kernel's ``tbl_ref``), counted apart by
``paged_launch_count()``.

A paged launch sizes its split plan from ``plan_len`` positions (the
engine passes a slot's full capacity, the dense cache's S), not from the
table's width: every table width then visits a slot's rows in the dense
launch's splits and order, so paged and dense launches over the same
contents give bit-identical outputs.

``fused_verify`` is the same layer over S positions per slot (speculative
verify, linear or token tree), with the contract of ``layers.mha_verify``:
the cache is read only and the new K/V come back raw as candidates. On a
CPU tensor it runs ``fused_verify_plain``; on CUDA tensors the three
launches of ``csrc/fused_verify.cu``, counted by ``verify_launch_count()``.
Its attention launch runs on the same decode-attention core, each (slot,
KV head)'s G*S query rows in one block (up to four m16 row tiles), counted
per route by ``verify_route_counts()``; paged launches also by
``paged_verify_launch_count()``. ``cost`` and ``verify_cost`` give one
layer's work (its three launches), dense or paged, bf16 or int8 cache.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.kernels import (_build, host_widths, launch_counter,
                                 refuse_grad)
from repro_torch.kernels import decode_attn as _da
from repro_torch.kernels import morph_matmul as _mm
from repro_torch.launch.op_analysis import kernel_launch
from repro_torch.models.layers import _cache_kpos
from repro_torch.models.paged import cache_rows, paged_view

KERNEL_NEG_INF = -1e30  # running-max init (flash_decode convention)

_LAUNCHES = {"n": 0, "tc": 0, "fma": 0, "paged": 0}
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_CACHE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_MAX_VERIFY_ROWS = 64  # positions the verify kernel scores per slot


def launch_count() -> int:
    """fused_decode_step calls that launched the kernels (3 launches each)."""
    return _LAUNCHES["n"]


def paged_launch_count() -> int:
    """fused_decode_step calls that launched the kernels over a page pool
    (also counted in ``launch_count``)."""
    return _LAUNCHES["paged"]


def route_counts() -> dict:
    """fused_decode_step calls per route of its attention kernel since
    import / reset, as the launch reports it: ``tc`` (bf16 or int8 cache,
    tensor cores) and ``fma`` (f32 cache, f32 FMAs)."""
    return {r: _LAUNCHES[r] for r in ("tc", "fma")}


def reset_launch_count() -> None:
    for k in _LAUNCHES:
        _LAUNCHES[k] = 0


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


def fused_decode_plain(params, x, cache, pos, cfg, a_q=None, a_kv=None,
                       pages=None, page_size=0):
    """Plain PyTorch mirror of the kernels (f32 math, one softmax pass).
    With ``pages`` (B, P) the cache leaves are page pools, read through the
    gathered per-slot view and written at the physical row of each slot's
    position."""
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

    def view(buf):
        return paged_view(buf, pages, page_size)

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
        kc = view(cache["k"]).float() * view(cache["k_scale"]).float()
        vc = view(cache["v"]).float() * view(cache["v_scale"]).float()
    else:
        k_st, v_st = kn.to(cache["k"].dtype), vn.to(cache["v"].dtype)
        ke, ve = k_st.float(), v_st.float()
        kc, vc = view(cache["k"]).float(), view(cache["v"]).float()
    S = kc.shape[1]
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
    rows = cache_rows(pages, slot, page_size)
    cache["k"][rows] = k_st
    cache["v"][rows] = v_st
    if quant:
        cache["k_scale"][rows] = ks_st
        cache["v_scale"][rows] = vs_st
    return out, cache


def _layer_bytes(B, R, dm, H, KV, hd, lens, aq, akv, x_dtype, w_dtype,
                 cache_dtype, pages, verify):
    """Bytes of one fused layer over R query rows a slot: the live f32
    weight blocks (QKV and ``wo``, the widest slot's widths) read once,
    every slot's live cache rows (and an int8 cache's bf16 scales) read
    once, x read and the output written once, the new K and V written once
    (into the cache, or as the verify's candidates in x's dtype), and the
    page table."""
    quant = cache_dtype == torch.int8
    row = hd * cache_dtype.itemsize + (2 if quant else 0)  # per KV head
    return (dm * (max(aq) + 2 * max(akv)) * w_dtype.itemsize
            + max(aq) * dm * w_dtype.itemsize
            + sum(lens) * KV * row * 2
            + 2 * B * R * dm * x_dtype.itemsize
            + 2 * B * R * KV * (hd * x_dtype.itemsize if verify else row)
            + (pages[0] * pages[1] * 4 if pages else 0))


def cost(B: int, dm: int, H: int, KV: int, hd: int, lens=None, *,
         S: int, active_q=None, active_kv=None,
         x_dtype: torch.dtype = torch.bfloat16,
         w_dtype: torch.dtype = torch.float32,
         cache_dtype: torch.dtype = torch.bfloat16, pages=None
         ) -> tuple:
    """(FLOPs, bytes) of one ``fused_decode_step`` (its three launches):
    ``lens`` the cache rows each slot reads (None: all ``S`` a slot
    sees), ``active_*`` the width gates (None or meta: full), ``pages``
    the page table's (B, P) for a paged launch. FLOPs: the gated QKV and
    ``wo`` products and 4 hd per cache row and query head, in f32."""
    lens = [S] * B if lens is None else [min(int(n), S) for n in lens]
    aq = [min(a, H * hd) for a in host_widths(active_q, H * hd, B)]
    akv = [min(a, KV * hd) for a in host_widths(active_kv, KV * hd, B)]
    nbytes = _layer_bytes(B, 1, dm, H, KV, hd, lens, aq, akv, x_dtype,
                          w_dtype, cache_dtype, pages, False)
    ops = sum(2 * dm * (q + 2 * kv) + 2 * q * dm + 4 * n * H * hd
              for q, kv, n in zip(aq, akv, lens))
    return float(ops), float(nbytes)


def _lib():
    lib = _build.load("fused_decode")
    qkv, attn = lib.fused_qkv_launch, lib.fused_attn_launch
    if qkv.argtypes is None:
        qkv.argtypes = [_P, _I, _P, _P, _P, _I] + [_P] * 5 + [_I] * 6 + [_P]
        qkv.restype = _I
        attn.argtypes = ([_P] * 7 + [_I] + [_P] * 2 + [_I] * 5 + [_P]
                         + [_I] * 6 + [_F, _F, _P, _P])
        attn.restype = _I
    return qkv, attn


def attn_plan(B: int, H: int, KV: int, hd: int, S: int,
              cache_dtype: torch.dtype, device) -> tuple:
    """(splits, rows per split) of the attention launch
    (``decode_attn.plan``: one cluster per (slot, KV head) and group of 16
    heads)."""
    return _da.plan("fused_decode", "fused_attn_max_clusters",
                    (_CACHE_CODE[cache_dtype], hd), B * KV, H // KV, S,
                    device)


def _cache_operands(cache, B, KV, hd, pages, page_size, quant, dev):
    """Checks the cache operands of a CUDA launch. Returns (S, table
    pointer, page size, table width, scale pointers): S the positions a slot
    sees, a dense cache's length or ``P * page_size`` through the (B, P)
    page table ``pages`` over a page pool (n_pages, page_size, KV, hd)."""
    kc, vc = cache["k"], cache["v"]
    if pages is None:
        S = kc.shape[1]
        want = (B, S, KV, hd)
        table, ps, P = None, 1, 1
    else:
        _mm._check(pages, "page table", dev, (torch.int32,))
        ps, P = int(page_size), pages.shape[1]
        if pages.dim() != 2 or pages.shape[0] != B or ps < 1:
            raise ValueError(f"page table must be (B, P) = ({B}, P) with a "
                             f"positive page size, got {tuple(pages.shape)} "
                             f"and page_size {page_size}")
        S = P * ps
        want = (kc.shape[0], ps, KV, hd)
        table = pages.data_ptr()
    if kc.dim() != 4 or tuple(kc.shape) != want or kc.shape != vc.shape:
        raise ValueError(f"cache must be {'a page pool (n_pages, page_size, '
                         'KV, hd)' if pages is not None else '(B, S, KV, hd)'}"
                         f" = {want}, got {tuple(kc.shape)}")
    for name, t in (("k", kc), ("v", vc)):
        _mm._check(t, f"cache {name}", dev, tuple(_CACHE_CODE))
    if (kc.dtype == torch.int8) != quant or vc.dtype != kc.dtype:
        raise TypeError(f"cache dtype {kc.dtype} does not match "
                        f"kv_quant={quant}")
    if quant:
        ks, vs = cache["k_scale"], cache["v_scale"]
        for name, t in (("k_scale", ks), ("v_scale", vs)):
            _mm._check(t, name, dev, (torch.bfloat16,))
        scales = (ks.data_ptr(), vs.data_ptr())
    else:
        scales = (None, None)
    return S, table, ps, P, scales


def _plan_len(S: int, plan_len: int) -> int:
    """Positions a launch's split plan is sized for: ``plan_len`` (a paged
    slot's full capacity) or the launch's own S."""
    if plan_len and plan_len < S:
        raise ValueError(f"plan_len {plan_len} is shorter than the {S} "
                         f"positions the launch sees")
    return plan_len or S


def _fused_decode_cuda(params, x, cache, pos, cfg, a_q, a_kv, pages,
                       page_size, plan_len):
    refuse_grad("fused_decode", x,
                *(params[k] for k in ("wq", "wk", "wv", "wo")))
    if x.is_meta:
        return _meta_layer(params, x, cache, cfg, a_q, a_kv, pages,
                           page_size, False) + (_meta_route(cache),)
    dev = x.device
    B, _, dm = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    wq, wk, wv, wo = params["wq"], params["wk"], params["wv"], params["wo"]
    for name, t in (("x", x), ("wq", wq), ("wk", wk), ("wv", wv), ("wo", wo)):
        _mm._check(t, name, dev)
    if not (wq.dtype == wk.dtype == wv.dtype):
        raise TypeError("wq, wk and wv must share one dtype")
    kc, vc = cache["k"], cache["v"]
    S, table, ps, P, (ks_p, vs_p) = _cache_operands(
        cache, B, KV, hd, pages, page_size, bool(cfg.kv_quant), dev)
    if pos.dim() == 0:
        pos = pos.expand(B)
    pos = pos.contiguous()
    _mm._check(pos, "pos", dev, (torch.int32,))
    if hd > _da.MAX_HD or hd % 2:
        raise ValueError(f"the attention kernel takes an even hd <= "
                         f"{_da.MAX_HD}, got {hd}")
    stream = torch.cuda.current_stream(dev).cuda_stream
    qkv_fn, attn_fn = _lib()
    qd, kvd = H * hd, KV * hd
    q = torch.empty((B, qd), dtype=torch.float32, device=dev)
    k = torch.empty((B, kvd), dtype=torch.float32, device=dev)
    v = torch.empty((B, kvd), dtype=torch.float32, device=dev)
    splits, kps = _mm.plan([qd, kvd, kvd], dm, B, x.dtype, wq.dtype,
                          False, dev)
    err = qkv_fn(x.data_ptr(), _mm._DTYPE_CODE[x.dtype], wq.data_ptr(),
                 wk.data_ptr(), wv.data_ptr(), _mm._DTYPE_CODE[wq.dtype],
                 q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 _mm._gate_ptr(a_q, B, dev), _mm._gate_ptr(a_kv, B, dev),
                 B, dm, qd, kvd, splits, kps, stream)
    if err != 0:
        raise RuntimeError(f"fused QKV kernel launch failed: CUDA error {err}")
    att = torch.empty((B, qd), dtype=torch.float32, device=dev)
    rope_coef = float(np.float32(math.log(cfg.rope_theta) / (hd // 2)))
    splits, rows = attn_plan(B, H, KV, hd, _plan_len(S, plan_len), kc.dtype,
                             dev)
    route = ctypes.c_int(-1)
    err = attn_fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), kc.data_ptr(),
                  vc.data_ptr(), ks_p, vs_p, _CACHE_CODE[kc.dtype],
                  pos.data_ptr(), att.data_ptr(), B, H, KV, hd, S, table, ps,
                  P, int(cfg.sliding_window), int(bool(cfg.use_rope)),
                  splits, rows, rope_coef, 1.0 / math.sqrt(hd),
                  ctypes.byref(route), stream)
    if err != 0:
        raise RuntimeError(f"fused attention kernel launch failed: "
                           f"CUDA error {err}")
    out = torch.empty((B, 1, wo.shape[1]), dtype=x.dtype, device=dev)
    _mm.launch(att.view(B, 1, qd), wo, out, None, a_q, round_w=False)
    return out, cache, _da.ROUTES[route.value]


def fused_decode_step(params, x, cache, pos, cfg, *, active=None, pages=None,
                      page_size=0, plan_len=0):
    """Fused one-token decode of one attention layer: (out (B,1,d), cache),
    with ``cache`` updated in place. ``pos``: (B,) int32 per-slot positions
    (or a scalar shared by every slot). With ``pages`` (B, P) int32 the
    cache leaves are page pools (n_pages, page_size, KV, hd) read and
    written through the table; ``plan_len`` sizes the kernel's split plan
    (a slot's full capacity; 0: ``P * page_size``)."""
    B = x.shape[0]
    a_q, a_kv = _gates(active, B, x.device)
    if pages is not None and torch.as_tensor(pos).dim() == 0:
        raise ValueError("paged decode needs per-slot positions (pos (B,))")
    if x.device.type == "cpu":
        return fused_decode_plain(params, x, cache, pos, cfg, a_q, a_kv,
                                  pages, page_size)
    pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device)
    out, cache, route = _fused_decode_cuda(params, x.contiguous(), cache,
                                           pos, cfg, a_q, a_kv, pages,
                                           page_size, plan_len)
    c = launch_counter(_LAUNCHES, "fused_decode")
    c["n"] += 1
    c[route] += 1
    c["paged"] += pages is not None
    return out, cache


# ---------------------------------------------------------------------------
# verify: S positions per slot, read-only cache, raw K/V candidates out
# ---------------------------------------------------------------------------

_VERIFY_LAUNCHES = {"n": 0, "tc": 0, "fma": 0, "paged": 0}
_VERIFY_ROWS: Dict[int, int] = {}  # S (positions per slot) -> calls
_VERIFY_OPERANDS: Dict[tuple, tuple] = {}


def verify_launch_count() -> int:
    """fused_verify calls that launched the verify kernels (3 launches
    each: QKV, attention, output projection)."""
    return _VERIFY_LAUNCHES["n"]


def paged_verify_launch_count() -> int:
    """fused_verify calls that launched the verify kernels over a page pool
    (also counted in ``verify_launch_count``)."""
    return _VERIFY_LAUNCHES["paged"]


def verify_route_counts() -> dict:
    """fused_verify calls per route of its attention kernel since import /
    reset, as the launch reports it: ``tc`` (bf16 or int8 cache, tensor
    cores) and ``fma`` (f32 cache, f32 FMAs)."""
    return {r: _VERIFY_LAUNCHES[r] for r in ("tc", "fma")}


def verify_launches_by_rows() -> dict:
    """fused_verify calls that launched the verify kernels, per S (the
    positions scored per slot: K + 1 for a linear draft of K, the node
    count of a tree)."""
    return dict(_VERIFY_ROWS)


def reset_verify_launch_count() -> None:
    for k in _VERIFY_LAUNCHES:
        _VERIFY_LAUNCHES[k] = 0
    _VERIFY_ROWS.clear()


def ext_mask_np(offs: np.ndarray, window: int,
                tree_bias: Optional[np.ndarray]) -> np.ndarray:
    """(S, S) bool: may row s attend to new-KV column c? A linear window is
    causal in offset; a tree uses its ancestor mask (``tree_bias == 0``).
    Both honor the sliding window. Port of ``_ext_mask_np``."""
    if tree_bias is None:
        ok = offs[None, :] <= offs[:, None]
    else:
        ok = np.asarray(tree_bias) == 0.0
    if window:
        ok = ok & (offs[None, :] > offs[:, None] - window)
    return np.ascontiguousarray(ok)


def verify_operands(S: int, node_depth, tree_bias, window: int, device):
    """(offs (S,) int32, ext_ok (S, S) int8) on ``device``: built once per
    topology and stream and cached, so a tree shares the kernel with linear
    verify. Per stream: a pair made on another thread's stream (the
    autoscaler's warm-up) is never read on this one, where its copy might
    not have landed yet."""
    offs = (np.arange(S, dtype=np.int32) if node_depth is None
            else np.array(node_depth, np.int32))  # a private, writable copy
    tb = None if tree_bias is None else np.asarray(tree_bias, np.float32)
    dev = torch.device(device)
    stream = (torch.cuda.current_stream(dev).stream_id
              if dev.type == "cuda" else 0)
    key = (offs.tobytes(), None if tb is None else tb.tobytes(), int(window),
           str(device), stream)
    ops = _VERIFY_OPERANDS.get(key)
    if ops is None:
        ok = ext_mask_np(offs, window, tb)
        ops = (torch.from_numpy(offs).to(device),
               torch.from_numpy(ok.astype(np.int8)).to(device))
        _VERIFY_OPERANDS[key] = ops
    return ops


def verify_cost(B: int, S: int, dm: int, H: int, KV: int, hd: int,
                lens=None, *, Sc: int, active_q=None, active_kv=None,
                x_dtype: torch.dtype = torch.bfloat16,
                w_dtype: torch.dtype = torch.float32,
                cache_dtype: torch.dtype = torch.bfloat16, pages=None
                ) -> tuple:
    """(FLOPs, bytes) of one ``fused_verify`` (its three launches) over S
    positions a slot: ``lens`` the committed cache rows each slot reads
    (None: all ``Sc``), the rest as ``cost``; the new K and V come out as
    candidates in x's dtype. FLOPs: the gated QKV and ``wo`` products over
    S rows and 4 per (query column, row, cache row or new position), in
    f32."""
    lens = [Sc] * B if lens is None else [min(int(n), Sc) for n in lens]
    aq = [min(a, H * hd) for a in host_widths(active_q, H * hd, B)]
    akv = [min(a, KV * hd) for a in host_widths(active_kv, KV * hd, B)]
    nbytes = _layer_bytes(B, S, dm, H, KV, hd, lens, aq, akv, x_dtype,
                          w_dtype, cache_dtype, pages, True)
    ops = sum(S * (2 * dm * (q + 2 * kv) + 2 * q * dm) + 4 * q * S * (n + S)
              for q, kv, n in zip(aq, akv, lens))
    return float(ops), float(nbytes)


def _meta_route(cache) -> str:
    return "fma" if cache["k"].dtype == torch.float32 else "tc"


def _meta_layer(params, x, cache, cfg, a_q, a_kv, pages, page_size,
                verify):
    """The meta route of ``fused_decode_step`` (x (B, 1, d)) and
    ``fused_verify`` (x (B, S, d)) inside an op trace: one launch recorded
    at the layer's cost over every cache row a slot sees, meta outputs."""
    B, S, dm = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    kc = cache["k"]
    seen = kc.shape[1] if pages is None else pages.shape[1] * int(page_size)
    kw = dict(active_q=a_q, active_kv=a_kv, x_dtype=x.dtype,
              w_dtype=params["wq"].dtype, cache_dtype=kc.dtype,
              pages=None if pages is None else tuple(pages.shape))
    out = x.new_empty((B, S, params["wo"].shape[1]))
    if not verify:
        kernel_launch("fused_decode", lambda: cost(B, dm, H, KV, hd, S=seen,
                                                   **kw))
        return out, cache
    kernel_launch("fused_verify", lambda: verify_cost(B, S, dm, H, KV, hd,
                                                      Sc=seen, **kw))
    return out, {"k": x.new_empty((B, S, KV, hd)),
                 "v": x.new_empty((B, S, KV, hd))}


def fused_verify_plain(params, x, cache, pos, cfg, a_q=None, a_kv=None,
                       node_depth=None, tree_bias=None, pages=None,
                       page_size=0):
    """Plain PyTorch mirror of the verify kernels (f32 math, one softmax
    over [cache, extension]): returns (out (B, S, d) in x's dtype,
    {"k", "v"} raw candidates (B, S, KV, hd) in x's dtype). The cache is
    read only; with ``pages`` (B, P) through the gathered per-slot view of
    its page pools. Non-quantized extension keys are attended in f32; with
    an int8 cache through the absmax round trip (bf16 scale), as the TPU
    kernel does (``fused_decode.py:660-673``)."""
    dt = x.dtype
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    G = H // KV
    dev = x.device
    pos = torch.as_tensor(pos, dtype=torch.int32, device=dev).expand(B)
    offs_t, ok_t = verify_operands(S, node_depth, tree_bias,
                                   cfg.sliding_window, dev)
    xf = x.float()

    def proj(w, a):
        y = xf @ w.float()
        if a is not None:
            cols = torch.arange(y.shape[-1], device=dev)[None, None, :]
            y = torch.where(cols < a[:, None, None], y,
                            torch.zeros((), device=dev))
        return y

    qpos = pos.long()[:, None] + offs_t.long()[None, :]  # (B, S)
    q = proj(params["wq"], a_q).view(B, S, H, hd)
    kn = proj(params["wk"], a_kv).view(B, S, KV, hd)
    vn = proj(params["wv"], a_kv).view(B, S, KV, hd)
    if cfg.use_rope:
        q = _rope_rows(q.view(B * S, H, hd), qpos.reshape(-1),
                       cfg.rope_theta).view(B, S, H, hd)
        kn = _rope_rows(kn.view(B * S, KV, hd), qpos.reshape(-1),
                        cfg.rope_theta).view(B, S, KV, hd)
    def view(buf):
        return paged_view(buf, pages, page_size)

    quant = bool(cfg.kv_quant)
    if quant:
        def trip(t):
            sc = t.abs().amax(-1, keepdim=True) / 127.0
            return (torch.round(t / torch.clamp(sc, min=1e-8))
                    * sc.to(torch.bfloat16).float())
        ke, ve = trip(kn), trip(vn)
        kc = view(cache["k"]).float() * view(cache["k_scale"]).float()
        vc = view(cache["v"]).float() * view(cache["v_scale"]).float()
    else:
        ke, ve = kn, vn
        kc, vc = view(cache["k"]).float(), view(cache["v"]).float()
    Sc = kc.shape[1]
    window = cfg.sliding_window
    kpos = _cache_kpos(pos, Sc, window)  # (B, Sc)
    qp = qpos[:, :, None]  # (B, S, 1)
    valid = (kpos[:, None, :] >= 0) & (kpos[:, None, :] <= qp)
    if window:
        valid = valid & (kpos[:, None, :] > qp - window)
    scale = 1.0 / math.sqrt(hd)
    neg = torch.full((), KERNEL_NEG_INF, device=dev)
    qg = q.view(B, S, KV, G, hd)
    s_c = torch.einsum("bskgd,bckd->bkgsc", qg, kc) * scale
    vmask = valid[:, None, None]  # (B, 1, 1, S, Sc)
    s_c = torch.where(vmask, s_c, neg)
    s_e = torch.einsum("bskgd,bckd->bkgsc", qg, ke) * scale
    emask = ok_t.bool()[None, None, None]  # (1, 1, 1, S, S)
    s_e = torch.where(emask, s_e, neg)
    m = torch.maximum(s_c.amax(-1, keepdim=True), s_e.amax(-1, keepdim=True))
    p_c = torch.where(vmask, torch.exp(s_c - m), torch.zeros((), device=dev))
    p_e = torch.where(emask, torch.exp(s_e - m), torch.zeros((), device=dev))
    l = p_c.sum(-1, keepdim=True) + p_e.sum(-1, keepdim=True)
    o = (torch.einsum("bkgsc,bckd->bskgd", p_c, vc)
         + torch.einsum("bkgsc,bckd->bskgd", p_e, ve))
    o = o / torch.clamp(l, min=1e-20).permute(0, 3, 1, 2, 4)
    o = o.reshape(B, S, H * hd)
    if a_q is not None:
        cols = torch.arange(H * hd, device=dev)[None, None, :]
        o = torch.where(cols < a_q[:, None, None], o,
                        torch.zeros((), device=dev))
    out = (o @ params["wo"].float()).to(dt)
    return out, {"k": kn.to(dt), "v": vn.to(dt)}


def _verify_lib():
    lib = _build.load("fused_verify")
    fn = lib.verify_attn_launch
    if fn.argtypes is None:
        lib.verify_qkv_launch.argtypes = (
            [_P, _I, _P, _P, _P, _I] + [_P] * 5 + [_I] * 7 + [_P])
        lib.verify_qkv_launch.restype = _I
        fn.argtypes = ([_P] * 7 + [_I] + [_P] * 6 + [_I] * 7 + [_P]
                       + [_I] * 6 + [_F, _F, _P, _P])
        fn.restype = _I
        lib.verify_attn_block_rows.argtypes = [_I, _I]
        lib.verify_attn_block_rows.restype = _I
    return lib.verify_qkv_launch, fn


def verify_attn_plan(B: int, H: int, KV: int, hd: int, S: int, Sc: int,
                     cache_dtype: torch.dtype, window: int, device) -> tuple:
    """(splits, rows per split) of the verify attention launch over an
    Sc-row cache (``decode_attn.plan``: one cluster per (slot, KV head) and
    group of the query rows a block carries, from the kernel's own
    occupancy at this S)."""
    code = _CACHE_CODE[cache_dtype]
    rows = _build.load("fused_verify").verify_attn_block_rows(code, hd)
    if rows <= 0:
        raise ValueError(f"the verify attention kernel takes hd <= "
                         f"{_da.MAX_HD}, got {hd}")
    return _da.plan("fused_verify", "verify_attn_max_clusters",
                    (code, hd, H // KV, S, int(bool(window))), B * KV,
                    (H // KV) * S, Sc, device, rows_per_block=rows)


def _fused_verify_cuda(params, x, cache, pos, cfg, a_q, a_kv, node_depth,
                       tree_bias, pages, page_size, plan_len):
    refuse_grad("fused_verify", x,
                *(params[k] for k in ("wq", "wk", "wv", "wo")))
    if x.is_meta:
        return _meta_layer(params, x, cache, cfg, a_q, a_kv, pages,
                           page_size, True) + (_meta_route(cache),)
    dev = x.device
    B, S, dm = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    wq, wk, wv, wo = params["wq"], params["wk"], params["wv"], params["wo"]
    for name, t in (("x", x), ("wq", wq), ("wk", wk), ("wv", wv), ("wo", wo)):
        _mm._check(t, name, dev)
    if not (wq.dtype == wk.dtype == wv.dtype):
        raise TypeError("wq, wk and wv must share one dtype")
    kc, vc = cache["k"], cache["v"]
    Sc, table, ps, P, (ks_p, vs_p) = _cache_operands(
        cache, B, KV, hd, pages, page_size, bool(cfg.kv_quant), dev)
    pos = pos.expand(B).contiguous() if pos.dim() == 0 else pos.contiguous()
    _mm._check(pos, "pos", dev, (torch.int32,))
    if not 0 < S <= _MAX_VERIFY_ROWS:
        raise ValueError(f"the verify kernel scores 1..{_MAX_VERIFY_ROWS} "
                         f"positions per slot, got S={S}")
    if hd > _da.MAX_HD or hd % 2:
        raise ValueError(f"the attention kernel takes an even hd <= "
                         f"{_da.MAX_HD}, got {hd}")
    offs, ext_ok = verify_operands(S, node_depth, tree_bias,
                                   cfg.sliding_window, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    qkv_fn, attn_fn = _verify_lib()
    qd, kvd = H * hd, KV * hd
    R = B * S
    q = torch.empty((R, qd), dtype=torch.float32, device=dev)
    k = torch.empty((R, kvd), dtype=torch.float32, device=dev)
    v = torch.empty((R, kvd), dtype=torch.float32, device=dev)
    splits, kps = _mm.plan([qd, kvd, kvd], dm, R, x.dtype, wq.dtype,
                          False, dev)
    err = qkv_fn(x.data_ptr(), _mm._DTYPE_CODE[x.dtype], wq.data_ptr(),
                 wk.data_ptr(), wv.data_ptr(), _mm._DTYPE_CODE[wq.dtype],
                 q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 _mm._gate_ptr(a_q, B, dev), _mm._gate_ptr(a_kv, B, dev),
                 B, S, dm, qd, kvd, splits, kps, stream)
    if err != 0:
        raise RuntimeError(f"verify QKV kernel launch failed: CUDA error {err}")
    att = torch.empty((R, qd), dtype=torch.float32, device=dev)
    k_new = torch.empty((B, S, KV, hd), dtype=x.dtype, device=dev)
    v_new = torch.empty_like(k_new)
    rope_coef = float(np.float32(math.log(cfg.rope_theta) / (hd // 2)))
    window = int(cfg.sliding_window)
    splits, rows = verify_attn_plan(B, H, KV, hd, S, _plan_len(Sc, plan_len),
                                    kc.dtype, window, dev)
    route = ctypes.c_int(-1)
    err = attn_fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), kc.data_ptr(),
                  vc.data_ptr(), ks_p, vs_p, _CACHE_CODE[kc.dtype],
                  pos.data_ptr(), offs.data_ptr(), ext_ok.data_ptr(),
                  att.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
                  _mm._DTYPE_CODE[x.dtype], B, H, KV, hd, S, Sc, table, ps, P,
                  window, int(bool(cfg.use_rope)), splits, rows, rope_coef,
                  1.0 / math.sqrt(hd), ctypes.byref(route), stream)
    if err != 0:
        raise RuntimeError(f"verify attention kernel launch failed: "
                           f"CUDA error {err}")
    out = torch.empty((B, S, wo.shape[1]), dtype=x.dtype, device=dev)
    _mm.launch(att.view(B, S, qd), wo, out, None, a_q, round_w=False)
    return out, {"k": k_new, "v": v_new}, _da.ROUTES[route.value]


def fused_verify(params, x, cache, pos, cfg, *, active=None, node_depth=None,
                 tree_bias=None, pages=None, page_size=0, plan_len=0):
    """Fused verify of one attention layer over S positions per slot: same
    contract as ``layers.mha_verify`` — returns (out (B, S, d), {"k", "v"}
    raw candidates (B, S, KV, hd)); the cache is read, never written.
    ``node_depth`` (S,) / ``tree_bias`` (S, S) select a token tree's
    positions and ancestor mask (numpy); both default to the linear window.
    With ``pages`` (B, P) int32 the cache leaves are page pools read
    through the table; ``plan_len`` sizes the attention kernel's split plan
    (a slot's full capacity; 0: ``P * page_size``).

    On CPU tensors it runs ``fused_verify_plain``; on CUDA tensors the
    three launches of ``csrc/fused_verify.cu`` (QKV, attention, output
    projection through the morph_matmul kernel), or it raises."""
    B = x.shape[0]
    a_q, a_kv = _gates(active, B, x.device)
    if x.device.type == "cpu":
        return fused_verify_plain(params, x, cache, pos, cfg, a_q, a_kv,
                                  node_depth, tree_bias, pages, page_size)
    pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device)
    out, kv, route = _fused_verify_cuda(params, x.contiguous(), cache, pos,
                                        cfg, a_q, a_kv, node_depth, tree_bias,
                                        pages, page_size, plan_len)
    c = launch_counter(_VERIFY_LAUNCHES, "fused_verify")
    c["n"] += 1
    c[route] += 1
    c["paged"] += pages is not None
    rows = launch_counter(_VERIFY_ROWS, "fused_verify_rows")
    rows[x.shape[1]] = rows.get(x.shape[1], 0) + 1
    return out, kv
