"""Core transformer layers: norms, positions, MLPs, GQA attention.

Port of ``repro.models.layers`` (the decode and prefill parts). Functional
style kept: ``init_*`` builds a param subtree (plain dicts of tensors with
the JAX tree keys), the other functions consume (params, inputs).
Activations run in ``cfg.dtype``; params are stored in ``cfg.param_dtype``.
Products accumulate in f32: bf16 operands are upcast for ``einsum`` (exact
products, f32 sums), which is what JAX's ``preferred_element_type=f32``
computes.

Where JAX returns a new cache, ``mha_decode`` writes the new K/V into the
cache tensors in place (JAX donates the cache buffer for the same effect).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import dtype_of

NEG_INF = -1e9

# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, shape, in_axis: int = 0,
               scale: float = 1.0, dtype=torch.float32, device=None,
               lead: tuple = ()):
    """Truncated-normal fan-in init (maxtext-style), drawn from ``gen``.

    ``shape`` is the per-leaf shape that sets the fan-in; ``lead`` prepends
    stacking axes (the ``n_groups`` axis of the layer stack)."""
    fan_in = shape[in_axis] if in_axis >= 0 else int(math.prod(shape[:-1]))
    std = scale / math.sqrt(fan_in)
    t = torch.empty(tuple(lead) + tuple(shape), dtype=torch.float32,
                    device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (t * std).to(dtype)


def matmul(x, w, dtype):
    """x @ w with w cast to ``dtype``; f32 accumulation, ``dtype`` result.
    Left to ``torch.matmul`` as the JAX package leaves it to XLA."""
    return torch.matmul(x.to(dtype), w.to(dtype))


def morph_proj(x, w, active_n=None, active_k=None):
    """Width-gated projection on the decode hot path (NeuroMorph clock gate).

    Routes through the ``morph_matmul`` kernel: output columns >= active_n
    are exactly zero; contraction rows >= active_k contribute nothing.
    ``active_n`` / ``active_k`` may be per-batch ``(B,)`` tensors.
    x: (B, S, d); w: (d, N) in its stored dtype (the kernel casts it to x's
    dtype on load).
    """
    from repro_torch.kernels.morph_matmul import morph_matmul

    if active_n is None and active_k is None:
        return matmul(x, w, x.dtype)
    return morph_matmul(x.contiguous(), w, active_n, active_k)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def init_norm(cfg: ModelConfig, d: Optional[int] = None, *, lead=(),
              device=None):
    d = d or cfg.d_model
    pd = dtype_of(cfg.param_dtype)
    shape = tuple(lead) + (d,)
    if cfg.norm == "layernorm":
        return {"scale": torch.ones(shape, dtype=pd, device=device),
                "bias": torch.zeros(shape, dtype=pd, device=device)}
    return {"scale": torch.ones(shape, dtype=pd, device=device)}


def apply_norm(params, x, cfg: ModelConfig, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    if "bias" in params:  # layernorm
        mean = x.mean(-1, keepdim=True)
        var = (x - mean).square().mean(-1, keepdim=True)
        y = (x - mean) * torch.rsqrt(var + eps)
        y = y * params["scale"].float() + params["bias"].float()
    else:  # rmsnorm
        var = x.square().mean(-1, keepdim=True)
        y = x * torch.rsqrt(var + eps) * params["scale"].float()
    return y.to(dt)


def apply_norm_masked(params, x, cfg: ModelConfig, n_active, eps: float = 1e-6):
    """RMSNorm whose mean-square spans only the first ``n_active`` channels
    (x is exactly zero beyond them). ``n_active``: scalar or per-batch (B,)."""
    assert "bias" not in params, "masked norm is rmsnorm-only"
    dt = x.dtype
    xf = x.float()
    n = torch.as_tensor(n_active, dtype=torch.float32, device=x.device)
    if n.dim():
        n = n.reshape(tuple(n.shape) + (1,) * (x.dim() - n.dim()))
    var = xf.square().sum(-1, keepdim=True) / torch.clamp(n, min=1.0)
    y = xf * torch.rsqrt(var + eps) * params["scale"].float()
    return y.to(dt)


# ---------------------------------------------------------------------------
# positions
# ---------------------------------------------------------------------------


def rope(x, positions, theta: float):
    """Apply rotary embeddings. x: (..., S, H, hd); positions: (..., S)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = torch.exp(-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device)
                      * (math.log(theta) / half))
    angles = positions[..., :, None].float() * freqs  # (..., S, half)
    cos = torch.cos(angles)[..., :, None, :]  # (..., S, 1, half)
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP (dense)
# ---------------------------------------------------------------------------


def init_mlp(gen, cfg: ModelConfig, d_ff: Optional[int] = None, *, lead=(),
             device=None):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    pd = dtype_of(cfg.param_dtype)
    p = {"wi": dense_init(gen, (d, f), dtype=pd, device=device, lead=lead),
         "wo": dense_init(gen, (f, d), dtype=pd, device=device, lead=lead)}
    if cfg.activation == "swiglu":
        p["wg"] = dense_init(gen, (d, f), dtype=pd, device=device, lead=lead)
    return p


def apply_mlp(params, x, cfg: ModelConfig, active_ff=None):
    """Dense MLP. ``active_ff`` (scalar or per-batch (B,)) runtime-gates the
    hidden columns: columns >= active_ff are exactly zero after the up
    projection and skipped by the down projection's contraction."""
    dt = x.dtype
    h = morph_proj(x, params["wi"], active_n=active_ff)
    if cfg.activation == "swiglu":
        g = morph_proj(x, params["wg"], active_n=active_ff)
        h = torch.nn.functional.silu(g.float()).to(dt) * h
    elif cfg.activation == "squared_relu":
        h = torch.relu(h).square()
    else:  # gelu (tanh approximation, jax.nn.gelu's default)
        h = torch.nn.functional.gelu(h.float(), approximate="tanh").to(dt)
    return morph_proj(h, params["wo"], active_k=active_ff)


# ---------------------------------------------------------------------------
# GQA attention (full / sliding window; prefill, decode)
# ---------------------------------------------------------------------------


def init_attention(gen, cfg: ModelConfig, *, lead=(), device=None):
    d = cfg.d_model
    pd = dtype_of(cfg.param_dtype)
    kw = dict(dtype=pd, device=device, lead=lead)
    return {
        "wq": dense_init(gen, (d, cfg.q_dim), **kw),
        "wk": dense_init(gen, (d, cfg.kv_dim), **kw),
        "wv": dense_init(gen, (d, cfg.kv_dim), **kw),
        "wo": dense_init(gen, (cfg.q_dim, d), **kw),
    }


def _split_heads(x, n, hd):
    return x.reshape(tuple(x.shape[:-1]) + (n, hd))


def _attn_mask(q_pos, k_pos, causal: bool, window: int):
    """(..., Sq, Sk) additive mask."""
    dq = q_pos[..., :, None]
    dk = k_pos[..., None, :]
    bad = dk < 0  # unwritten / padded slots carry pos < 0
    if causal:
        bad = bad | (dk > dq)
    if window > 0:
        bad = bad | (dk <= dq - window)
    return torch.where(bad, torch.full((), NEG_INF, device=bad.device),
                       torch.zeros((), device=bad.device))


def _gqa_scores(q, k, cfg: ModelConfig):
    """q: (B,Sq,H,hd), k: (B,Sk,KV,hd) -> (B,KV,H/KV,Sq,Sk) f32."""
    groups = cfg.n_heads // max(cfg.n_kv_heads, 1)
    B, Sq, H, hd = q.shape
    qg = q.reshape(B, Sq, cfg.n_kv_heads, groups, hd)
    s = torch.einsum("bqkgh,bskh->bkgqs", qg.float(), k.float())
    return s / math.sqrt(hd)


def _gqa_out(w, v, cfg: ModelConfig):
    """w: (B,KV,G,Sq,Sk) f32, v: (B,Sk,KV,hd) -> (B,Sq,H,hd) f32. The
    probabilities are rounded to v's storage dtype first, as in JAX."""
    B = w.shape[0]
    o = torch.einsum("bkgqs,bskh->bqkgh", w.to(v.dtype).float(), v.float())
    return o.reshape(B, o.shape[1], cfg.n_heads, cfg.head_dim)


def attention_full(q, k, v, cfg: ModelConfig, q_pos, k_pos, causal=True,
                   bias=None):
    """Plain einsum attention. ``bias`` is an optional additive (Sq, Sk)."""
    s = _gqa_scores(q, k, cfg)
    mask = _attn_mask(q_pos, k_pos, causal, cfg.sliding_window)
    s = s + mask[:, None, None] if mask.dim() == 3 else s + mask
    if bias is not None:
        s = s + bias
    w = torch.softmax(s, dim=-1)
    return _gqa_out(w, v, cfg).to(q.dtype)


def attention_chunked(q, k, v, cfg: ModelConfig, q_pos, k_pos, causal=True):
    """Blockwise (flash-style) attention in plain PyTorch: a loop over KV
    chunks carrying running (max, sum, acc), O(Sq * chunk) memory."""
    B, Sq, H, hd = q.shape
    Sk = k.shape[1]
    chunk = min(cfg.attn_chunk, Sk)
    n_chunks = (Sk + chunk - 1) // chunk
    pad = n_chunks * chunk - Sk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        k_pos = torch.nn.functional.pad(k_pos, (0, pad), value=-10**9)
    groups = H // max(cfg.n_kv_heads, 1)
    qg = q.reshape(B, Sq, cfg.n_kv_heads, groups, hd).float()
    m = torch.full((B, cfg.n_kv_heads, groups, Sq), NEG_INF, device=q.device)
    l = torch.zeros((B, cfg.n_kv_heads, groups, Sq), device=q.device)
    acc = torch.zeros((B, cfg.n_kv_heads, groups, Sq, hd), device=q.device)
    for c in range(n_chunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        k_i, v_i, p_i = k[:, sl], v[:, sl], k_pos[..., sl]
        s = torch.einsum("bqkgh,bskh->bkgqs", qg, k_i.float()) / math.sqrt(hd)
        s = s + _attn_mask(q_pos, p_i, causal, cfg.sliding_window)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        pv = torch.einsum("bkgqs,bskh->bkgqh", p.to(v_i.dtype).float(),
                          v_i.float())
        acc = acc * alpha[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l, min=1e-20)[..., None]
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd)
    return out.to(q.dtype)


def mha(params, x, cfg: ModelConfig, positions, *, kv_x=None,
        kv_positions=None, causal=True):
    """Full-sequence attention (prefill). Returns (out, (k, v))."""
    dt = x.dtype
    q = _split_heads(matmul(x, params["wq"], dt), cfg.n_heads, cfg.head_dim)
    kv_in = x if kv_x is None else kv_x
    k = _split_heads(matmul(kv_in, params["wk"], dt), cfg.n_kv_heads,
                     cfg.head_dim)
    v = _split_heads(matmul(kv_in, params["wv"], dt), cfg.n_kv_heads,
                     cfg.head_dim)
    kpos = positions if kv_positions is None else kv_positions
    if cfg.use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, kpos, cfg.rope_theta)
    Sk = k.shape[1]
    impl = cfg.attn_impl
    if impl == "auto":
        impl = "chunked" if Sk > 2048 else "einsum"
    fn = attention_chunked if impl == "chunked" else attention_full
    out = fn(q, k, v, cfg, positions, kpos, causal=causal)
    out = matmul(out.reshape(out.shape[0], out.shape[1], cfg.q_dim),
                 params["wo"], dt)
    return out, (k, v)


# --- decode path with KV cache ---------------------------------------------


def quantize_kv(x):
    """int8 per-(batch,pos,head) absmax quantization, half-to-even rounding."""
    scale = x.abs().amax(-1, keepdim=True).float() / 127.0
    q = torch.round(x.float() / torch.clamp(scale, min=1e-8)).to(torch.int8)
    return q, scale.to(torch.bfloat16)


def dequantize_kv(q, scale, dtype):
    return (q.float() * scale.float()).to(dtype)


def init_kv_cache(cfg: ModelConfig, batch: int, seq: int, dtype, *,
                  lead=(), device=None):
    """KV cache for one attention layer. SWA uses a rolling window buffer."""
    window = cfg.sliding_window
    s = min(seq, window) if window else seq
    shape = tuple(lead) + (batch, s, cfg.n_kv_heads, cfg.head_dim)
    z = dict(device=device)
    if cfg.kv_quant:
        return {
            "k": torch.zeros(shape, dtype=torch.int8, **z),
            "v": torch.zeros(shape, dtype=torch.int8, **z),
            "k_scale": torch.zeros(shape[:-1] + (1,), dtype=torch.bfloat16, **z),
            "v_scale": torch.zeros(shape[:-1] + (1,), dtype=torch.bfloat16, **z),
        }
    return {"k": torch.zeros(shape, dtype=dtype, **z),
            "v": torch.zeros(shape, dtype=dtype, **z)}


def _decode_kpos(pos_b, S: int, window: int):
    """Absolute position of each of the S cache columns after this step's
    write, given per-slot positions ``pos_b`` (B,): (B, S), -1e9 = masked."""
    idx = torch.arange(S, device=pos_b.device)[None, :]
    p = pos_b.long()[:, None]
    if window:
        wraps = torch.where(idx <= torch.remainder(p, S), 0, 1)
        kpos = (torch.div(p, S, rounding_mode="floor") - wraps) * S + idx
        return torch.where(kpos < 0, -10**9, kpos)
    return torch.where(idx <= p, idx, -10**9)


def mha_decode(params, x, cache, pos, cfg: ModelConfig, *, cross=False,
               active=None, pages=None, page_size=0, fused=False):
    """One-token decode. x: (B,1,d); cache dict; pos: scalar int32 or (B,)
    per-slot positions.

    ``active`` (dict with "q_dim"/"kv_dim", scalars or per-batch (B,))
    runtime-gates the projections: columns beyond each slot's active width
    are exactly zero, and the output projection's contraction skips inactive
    head columns — one code path serves every width.

    The new K/V is written into ``cache`` in place (at each slot's position,
    rolling for sliding windows) and attention then reads the updated cache;
    returns (out, cache). ``fused=True`` routes through
    ``kernels.fused_decode_step`` instead.
    """
    if cross:
        raise NotImplementedError("cross-attention decode arrives with the "
                                  "encoder-decoder slice of the port")
    if pages is not None:
        raise NotImplementedError("paged KV caches arrive with the paged "
                                  "slice of the port")
    if fused:
        from repro_torch.kernels.fused_decode import fused_decode_step
        return fused_decode_step(params, x, cache, pos, cfg, active=active)
    dt = x.dtype
    B = x.shape[0]
    a_q = active.get("q_dim") if active else None
    a_kv = active.get("kv_dim") if active else None
    pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device)
    pos_b = pos.expand(B) if pos.dim() == 0 else pos
    qpos = pos_b[:, None]
    q = _split_heads(morph_proj(x, params["wq"], active_n=a_q),
                     cfg.n_heads, cfg.head_dim)
    if cfg.use_rope:
        q = rope(q, qpos, cfg.rope_theta)
    k_new = _split_heads(morph_proj(x, params["wk"], active_n=a_kv),
                         cfg.n_kv_heads, cfg.head_dim)
    v_new = _split_heads(morph_proj(x, params["wv"], active_n=a_kv),
                         cfg.n_kv_heads, cfg.head_dim)
    if cfg.use_rope:
        k_new = rope(k_new, qpos, cfg.rope_theta)

    window = cfg.sliding_window
    S = cache["k"].shape[1]
    slot = (torch.remainder(pos_b.long(), S) if window
            else torch.clamp(pos_b.long(), max=S - 1))
    bix = torch.arange(B, device=x.device)

    def write(buf, new):
        buf[bix, slot] = new[:, 0].to(buf.dtype)

    if cfg.kv_quant:
        kq, ks = quantize_kv(k_new)
        vq, vs = quantize_kv(v_new)
        write(cache["k"], kq)
        write(cache["v"], vq)
        write(cache["k_scale"], ks)
        write(cache["v_scale"], vs)
        k = dequantize_kv(cache["k"], cache["k_scale"], dt)
        v = dequantize_kv(cache["v"], cache["v_scale"], dt)
    else:
        write(cache["k"], k_new)
        write(cache["v"], v_new)
        k, v = cache["k"].to(dt), cache["v"].to(dt)

    kpos = _decode_kpos(pos_b, S, window)
    out = attention_full(q, k, v, cfg, qpos, kpos, causal=True)
    out = morph_proj(out.reshape(B, 1, cfg.q_dim), params["wo"], active_k=a_q)
    return out, cache
