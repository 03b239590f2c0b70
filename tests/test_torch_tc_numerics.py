"""The arithmetic of the port's tensor-core kernels, emulated in PyTorch on
the CPU and held to the JAX package's Pallas kernels in interpret mode.

The CUDA kernels run only on a card (``test_torch_cuda.py`` holds them to
their plain versions there). What can be checked here is that the way they
compute is the function: the emulations below repeat the kernels' order of
work and rounding, on the same numpy inputs as the Pallas kernels.

* ``flash_attention``, bf16 route (``csrc/flash_attention.cu``,
  ``flash_attn_tc``): S from bf16 q and k with f32 sums, the finite -1e30
  mask, an online softmax per 16-row warp over 64-key tiles, the key tiles
  split between two warps (even and odd tiles) whose (max, sum, acc) are
  merged at the end, and P.V as two bf16 products, p_hi = bf16(p) and
  p_lo = bf16(p - p_hi), into f32. Tolerance: the outputs are bf16, so one
  bf16 step, rtol 2^-7 + atol 1e-3.
* ``morph_matmul``, rounding mode (``csrc/gemv.cuh``, ``tc_chunk``): f32
  weights rounded to bf16 (nearest even) on load, times bf16 x with f32
  sums, 64-row chunks summed in order inside a split, the splits' partials
  added in split order, gated rows and columns as the kernel gates them;
  the Pallas kernel gets the weight cast to bf16 first, as the model's
  ``morph_proj`` casts it. Same tolerance.
* The split planner (``kernels/morph_matmul.py``: ``_split_plan``): every
  split non-empty, each contraction row in exactly one split, at most 16
  splits, and one wave whenever more than one split is taken.
* The decode-attention core (``csrc/decode_attn.cuh``: ``flash_decode`` and
  the attention launch of ``fused_decode_step``), bf16 and int8 caches:
  f32 q split as q_hi + q_lo (bf16 q as it is) times the cache's exact
  values in bf16, f32 sums; an int8 cache's k scale applied to the score
  after Q.K^T and its v scale folded into p before P.V (l sums the
  unfolded p); an online softmax per warp over its 16 rows of every 64-row
  chunk of its split, the 4 warps merged in order, then the splits'
  partials merged in split order (with the new token's extension column in
  the fused decode); P.V as p_hi + p_lo. Held to the Pallas kernels in
  interpret mode: bf16 outputs to one bf16 step (rtol 2^-7 + atol 1e-3),
  f32 outputs to rtol 1e-4 + atol 1e-4 (the two splits keep q and p to
  about 2^-16, summed over 16..64 terms of O(1)).
* The same core under ``fused_verify`` (``csrc/fused_verify.cu``): the G*S
  query rows of a (slot, KV head) in one block (more than 16: several m16
  row tiles), each row RoPE'd at its own position and masked by its own
  window edge, the S extension columns scored in f32 and merged after the
  splits under the (S, S) mask ``ext_ok``. Held to
  ``repro.kernels.fused_decode.fused_verify(impl="pallas", interpret=True)``
  at one bf16 step (rtol 2^-7 + atol 1e-3).
* ``ssd_scan`` (``csrc/ssd_scan.cu``): 64-step tiles, every product as
  3xTF32 (each f32 operand split hi = tf32(a), lo = tf32(a - hi), the
  products lo*hi + hi*lo + hi*hi summed in f32), the tiles' state
  contributions and C.B^T in parallel, the carry in f32, then y_diag + y_off
  per tile. Held to the Pallas ``ssd_scan`` in interpret mode and to
  ``ssd_chunked`` at rtol 1e-4 + atol 1e-4 (the split keeps each product to
  3 * 2^-22 of |a b|).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dataclasses

from repro.configs import smoke_config as jax_smoke_config
from repro.kernels import fused_decode as JFD
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.flash_decode import flash_decode as jax_flash_decode
from repro.kernels.morph_matmul import morph_matmul as jax_morph_matmul
from repro.kernels.ssd_scan import ssd_scan as jax_ssd_scan
from repro.models import ssm as JSSM
from repro.runtime.speculative import tree_topology
from repro_torch.configs import smoke_config
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import flash_decode as FDK
from repro_torch.kernels import fused_decode as FD
from repro_torch.kernels import morph_matmul as MM
from repro_torch.kernels import ssd_scan as TSSD
from repro_torch.models.layers import _cache_kpos
from torch_threads import one_thread  # noqa: E402,F401  (autouse)

BF16_TOL = dict(atol=1e-3, rtol=2.0 ** -7)
F32_TOL = dict(atol=1e-4, rtol=1e-4)
NEG_INF = -1e30


def _bf16(a: np.ndarray):
    """One numpy array as a bf16 JAX array and a bf16 torch tensor."""
    return jnp.asarray(a).astype(jnp.bfloat16), torch.from_numpy(a).bfloat16()


def split_p(p: torch.Tensor):
    """p as p_hi + p_lo, both bf16 values (held in f32)."""
    hi = p.bfloat16().float()
    return hi, (p - hi).bfloat16().float()


def tc_flash(q, k, v, group, causal, window, bq=64, bk=64):
    """The tensor-core flash kernel's arithmetic. q (BH, Sq, hd), k and v
    (BKV, Sk, hd), bf16. Returns (BH, Sq, hd) bf16."""
    BH, Sq, hd = q.shape
    Sk = k.shape[1]
    scale = 1.0 / math.sqrt(hd)
    qf = q.float()
    kf = k.float().repeat_interleave(group, 0)
    vf = v.float().repeat_interleave(group, 0)
    out = torch.zeros(BH, Sq, hd)
    for q0 in range(0, Sq, bq):
        q_last = min(q0 + bq, Sq) - 1
        kt_end = -(-Sk // bk)
        if causal:
            kt_end = min(kt_end, q_last // bk + 1)
        kt_begin = 0
        while (window > 0 and kt_begin < kt_end
               and min(kt_begin * bk + bk, Sk) - 1 <= q0 - window):
            kt_begin += 1
        for w0 in range(q0, min(q0 + bq, Sq), 16):  # one warp's 16 rows
            w_last = min(w0 + 15, Sq - 1)
            rows = torch.arange(w0, w_last + 1)[:, None]
            halves = []
            for half in (0, 1):
                m = torch.full((BH, len(rows)), NEG_INF)
                l = torch.zeros(BH, len(rows))
                acc = torch.zeros(BH, len(rows), hd)
                for kt in range(kt_begin + half, kt_end, 2):
                    k0 = kt * bk
                    k1 = min(k0 + bk, Sk)
                    if causal and k0 > w_last:
                        continue
                    if window > 0 and k1 - 1 <= w0 - window:
                        continue
                    s = qf[:, w0:w_last + 1] @ kf[:, k0:k1].transpose(1, 2)
                    cols = torch.arange(k0, k1)[None, :]
                    bad = torch.zeros(len(rows), k1 - k0, dtype=torch.bool)
                    if causal:
                        bad |= cols > rows
                    if window > 0:
                        bad |= cols <= rows - window
                    x = s * scale + torch.where(bad, NEG_INF, 0.0)
                    m_new = torch.maximum(m, x.amax(-1))
                    alpha = torch.exp(m - m_new)
                    p = torch.exp(x - m_new[..., None])
                    l = l * alpha + p.sum(-1)
                    hi, lo = split_p(p)
                    acc = (acc * alpha[..., None] + hi @ vf[:, k0:k1]
                           + lo @ vf[:, k0:k1])
                    m = m_new
                halves.append((m, l, acc))
            (m0, l0, a0), (m1, l1, a1) = halves
            mx = torch.maximum(m0, m1)
            s0, s1 = torch.exp(m0 - mx), torch.exp(m1 - mx)
            den = torch.clamp(l0 * s0 + l1 * s1, min=1e-20)
            out[:, w0:w_last + 1] = ((a0 * s0[..., None] + a1 * s1[..., None])
                                     / den[..., None])
    return out.bfloat16()


def tc_morph(x, w, active_n, active_k, splits, k_per_split, chunk=64):
    """The rounding-mode morph_matmul kernel's arithmetic. x (B, M, K)
    bf16, w (K, N) f32, active widths per batch row. Returns (B, M, N)
    bf16."""
    B, M, K = x.shape
    N = w.shape[1]
    an = torch.as_tensor(active_n, dtype=torch.int64)
    ak = torch.as_tensor(active_k, dtype=torch.int64)
    max_k = int(ak.max())
    wb = w.bfloat16().float()
    k_ids = torch.arange(K)
    xb = torch.where(k_ids[None, None, :] < ak[:, None, None], x.float(), 0.0)
    total = torch.zeros(B, M, N)
    for s in range(splits):
        kb = s * k_per_split
        ke = min(max_k, kb + k_per_split)
        part = torch.zeros(B, M, N)
        for k0 in range(kb, ke, chunk):
            k1 = min(k0 + chunk, ke)
            part = part + xb[:, :, k0:k1] @ wb[k0:k1]
        total = total + part
    n_ids = torch.arange(N)
    total = torch.where(n_ids[None, None, :] < an[:, None, None], total, 0.0)
    return total.bfloat16()


def test_p_split_error_is_far_below_bf16():
    """|p - p_hi - p_lo| <= 2^-16 p over p in (0, 1] and tiny p: the split
    keeps p to about 16 bits, where one bf16 p keeps 8."""
    rng = np.random.default_rng(0)
    p = torch.from_numpy(np.concatenate([
        rng.random(100_000), np.exp(-rng.random(10_000) * 80)]).astype(
            np.float32))
    p = p[p > 0]
    hi, lo = split_p(p)
    rel = ((p - hi - lo).abs() / p).max().item()
    assert rel <= 2.0 ** -16
    assert ((p - hi).abs() / p).max().item() > 2.0 ** -10  # hi alone is bf16


@pytest.mark.parametrize("sq,sk,h,kv,hd,causal,window", [
    (128, 128, 4, 2, 32, True, 0),
    (128, 128, 2, 1, 64, True, 40),
    (64, 256, 2, 2, 16, False, 0),
])
def test_tc_flash_emulation_matches_pallas(sq, sk, h, kv, hd, causal, window):
    """The tensor-core kernel's arithmetic against the Pallas kernel in
    interpret mode (its own tiles, 64 x 64), bf16 inputs: causal GQA, a
    window of 40 (rows whose first visited tiles are wholly masked), and a
    non-causal Sq != Sk with four key tiles over two warps."""
    group = h // kv
    rng = np.random.default_rng(sq + sk + hd)
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in
               ((h, sq, hd), (kv, sk, hd), (kv, sk, hd)))
    (jq, tq), (jk, tk), (jv, tv) = _bf16(q), _bf16(k), _bf16(v)
    want = np.asarray(jax_flash(jq, jk, jv, group=group, causal=causal,
                                window=window, bq=64, bk=64,
                                interpret=True)).astype(np.float32)
    got = tc_flash(tq, tk, tv, group, causal, window)
    np.testing.assert_allclose(got.float().numpy(), want, **BF16_TOL)
    # and the port's plain version (f32 p) to the same tolerance
    plain = FA.flash_attention_plain(tq, tk, tv, group=group, causal=causal,
                                     window=window)
    np.testing.assert_allclose(got.float().numpy(), plain.float().numpy(),
                               **BF16_TOL)


@pytest.mark.parametrize("shape,splits", [((8, 5, 256, 96), 3),
                                          ((3, 1, 200, 64), 2),
                                          ((2, 8, 130, 40), 1)])
def test_tc_morph_emulation_matches_pallas(shape, splits):
    """The rounding-mode kernel's arithmetic (bf16 x, weights rounded to
    bf16, f32 sums by chunk and by split) against the Pallas kernel in
    interpret mode, with per-batch active_n / active_k that are not
    tile-aligned, at 40, 3 and 16 rows."""
    B, M, K, N = shape
    rng = np.random.default_rng(K + N)
    x = rng.standard_normal((B, M, K)).astype(np.float32)
    w = (rng.standard_normal((K, N)) / math.sqrt(K)).astype(np.float32)
    an = rng.integers(1, N + 1, B).astype(np.int32)
    ak = rng.integers(1, K + 1, B).astype(np.int32)
    chunks = -(-K // 64)
    per = -(-chunks // splits)
    jx, tx = _bf16(x)
    # the model casts the f32 master weight to x's dtype before the kernel
    # (repro/models/layers.py: morph_proj); the port's kernel rounds it on
    # load instead
    jw = jnp.asarray(w).astype(jnp.bfloat16)
    want = np.asarray(jax_morph_matmul(jx, jw, jnp.asarray(an),
                                       jnp.asarray(ak), interpret=True,
                                       impl="pallas")).astype(np.float32)
    got = tc_morph(tx, torch.from_numpy(w), an, ak, -(-chunks // per),
                   per * 64)
    np.testing.assert_allclose(got.float().numpy(), want, **BF16_TOL)
    plain = MM.morph_matmul_plain(tx, torch.from_numpy(w),
                                  torch.from_numpy(an), torch.from_numpy(ak))
    np.testing.assert_allclose(got.float().numpy(), plain.float().numpy(),
                               **BF16_TOL)
    for b in range(B):
        assert not got[b, :, an[b]:].any()


@pytest.mark.parametrize("n_cols,K,caps", [
    ((2048,), 2048, tuple(396 // s for s in range(1, 17))),
    ((256,), 2048, tuple(396 // s for s in range(1, 17))),
    ((5632,), 2048, tuple(264 // s for s in range(1, 17))),
    ((2048, 256, 256), 2048, tuple(264 // s for s in range(1, 17))),
    ((32,), 1024, tuple(132 // s for s in range(1, 17))),
    ((64,), 100, tuple(396 // s for s in range(1, 17))),
    ((8192,), 4096, (100,) * 16),
])
def test_split_plan_covers_each_row_once(n_cols, K, caps):
    """Every split holds at least one contraction row, together they hold
    each row once, there are at most 16, and taking more than one split
    means every tile's cluster fits on the card at once."""
    tiles, splits, kps = MM._split_plan(n_cols, K, caps)
    assert tiles == sum(-(-n // 64) for n in n_cols)
    assert 1 <= splits <= 16 and kps % 64 == 0
    assert (splits - 1) * kps < K <= splits * kps
    if splits > 1:
        assert caps[splits - 1] >= tiles
    # and no larger split count would have fit as well
    chunks = -(-K // 64)
    for s in range(splits + 1, min(16, chunks) + 1):
        assert caps[s - 1] < tiles or -(-chunks // -(-chunks // s)) == splits


# ---------------------------------------------------------------------------
# the decode-attention core
# ---------------------------------------------------------------------------


def tc_decode(q, k, v, ok, rps, k_scale=None, v_scale=None, ext=None,
              q_split=True, chunk=64, warp_rows=16):
    """The decode-attention core's tensor-core arithmetic for U units. q
    (U, G, hd) f32 (bf16 values when ``q_split`` is False); k, v (U, S, hd)
    the cache's values (bf16 or int8, held in f32); ok (U, S) the rows that
    attend, or (U, G, S) per query row; scales (U, S) for an int8 cache;
    ``ext`` (scores (U, G), values (U, hd)) an extension column, or (scores
    (U, G, E), ok (U, G, E), values (U, E, hd)) E columns, merged after the
    splits. Splits of ``rps`` rows, 64-row chunks, 16 rows per warp; the
    m16 row tiles of a block see the same chunks in the same order.
    Returns (U, G, hd) f32."""
    U, G, hd = q.shape
    S = k.shape[1]
    okq = ok[:, None, :] if ok.dim() == 2 else ok  # (U, G or 1, S)
    scale = 1.0 / math.sqrt(hd)
    if q_split:
        qh, ql = split_p(q)
        qq = (qh, ql)
    else:
        qq = (q,)
    neg = torch.tensor(NEG_INF)
    parts = []
    for r0 in range(0, max(S, 1), rps):
        warps = []
        for w in range(chunk // warp_rows):
            m = torch.full((U, G), NEG_INF)
            l = torch.zeros(U, G)
            acc = torch.zeros(U, G, hd)
            for c0 in range(r0, min(r0 + rps, S), chunk):
                a, b = c0 + w * warp_rows, min(c0 + (w + 1) * warp_rows, S)
                if a >= b:
                    continue
                kt, vt, okt = k[:, a:b], v[:, a:b], okq[:, :, a:b]
                s = sum(x @ kt.transpose(1, 2) for x in qq)  # (U, G, rows)
                f = scale if k_scale is None else scale * k_scale[:, None, a:b]
                x = torch.where(okt, s * f, neg)
                m_new = torch.maximum(m, x.amax(-1))
                alpha = torch.exp(m - m_new)
                p = torch.where(okt, torch.exp(x - m_new[..., None]),
                                torch.zeros(()))
                l = l * alpha + p.sum(-1)
                if v_scale is not None:
                    p = p * v_scale[:, None, a:b]
                hi, lo = split_p(p)
                acc = acc * alpha[..., None] + hi @ vt + lo @ vt
                m = m_new
            warps.append((m, l, acc))
        M = torch.stack([w[0] for w in warps]).amax(0)
        L = torch.zeros(U, G)
        A = torch.zeros(U, G, hd)
        for m, l, acc in warps:  # the block's partial, warps in order
            f = torch.exp(m - M)
            L = L + l * f
            A = A + acc * f[..., None]
        parts.append((M, L, A))
    M = torch.stack([p[0] for p in parts]).amax(0)
    if ext is not None:
        if len(ext) == 2:  # one column
            es, eok, ev = ext[0][..., None], None, ext[1][:, None, :]
            eok = torch.ones_like(es, dtype=torch.bool)
        else:
            es, eok, ev = ext
        M = torch.maximum(M, torch.where(eok, es, neg).amax(-1))
    L = torch.zeros(U, G)
    A = torch.zeros(U, G, hd)
    for m, l, acc in parts:  # the cluster's merge, in split order
        f = torch.exp(m - M)
        L = L + l * f
        A = A + acc * f[..., None]
    if ext is not None:  # then the extension columns, masked p zeroed
        pe = torch.where(eok, torch.exp(es - M[..., None]), torch.zeros(()))
        L = L + pe.sum(-1)
        A = A + pe @ ev
    return A / torch.clamp(L, min=1e-20)[..., None]


def test_q_split_error_is_far_below_bf16():
    """|q - q_hi - q_lo| <= 2^-16 |q|: the f32 queries of the fused decode
    keep about 16 bits through two bf16 products."""
    rng = np.random.default_rng(1)
    q = torch.from_numpy((rng.standard_normal(100_000)
                          * np.exp(rng.uniform(-20, 20, 100_000))).astype(
        np.float32))
    hi, lo = split_p(q)
    assert ((q - hi - lo).abs() / q.abs()).max().item() <= 2.0 ** -16


@pytest.mark.parametrize("cache,q_dt,rps", [("bf16", "bf16", 64),
                                            ("int8", "f32", 128),
                                            ("int8", "bf16", 64)])
def test_tc_flash_decode_emulation_matches_pallas(cache, q_dt, rps):
    """flash_decode over one KV row of 192 positions, group 8, hd 32, in
    splits of ``rps`` rows (3 splits of one chunk, or 2 of which the second
    is short), at kv_len 0, 1, a ragged 77 and the full cache: the core's
    arithmetic against the Pallas kernel in interpret mode, and the port's
    plain version against both."""
    G, S, hd = 8, 192, 32
    rng = np.random.default_rng(len(cache) + rps)
    q = rng.standard_normal((G, hd)).astype(np.float32)
    k = rng.standard_normal((1, S, hd)).astype(np.float32)
    v = rng.standard_normal((1, S, hd)).astype(np.float32)
    if cache == "int8":
        kq = np.clip(np.rint(k * 40), -127, 127).astype(np.int8)
        vq = np.clip(np.rint(v * 40), -127, 127).astype(np.int8)
        ks = rng.uniform(0.005, 0.05, (1, S, 1)).astype(np.float32)
        vs = rng.uniform(0.005, 0.05, (1, S, 1)).astype(np.float32)
        jk, jv = jnp.asarray(kq), jnp.asarray(vq)
        jks = jnp.asarray(ks).astype(jnp.bfloat16)
        jvs = jnp.asarray(vs).astype(jnp.bfloat16)
        tk, tv = torch.from_numpy(kq), torch.from_numpy(vq)
        tks = torch.from_numpy(ks).bfloat16()
        tvs = torch.from_numpy(vs).bfloat16()
        scales = (tks.float()[..., 0], tvs.float()[..., 0])
    else:
        (jk, tk), (jv, tv) = _bf16(k), _bf16(v)
        jks = jvs = tks = tvs = None
        scales = (None, None)
    if q_dt == "bf16":
        jq, tq = _bf16(q)
        tol = BF16_TOL
    else:
        jq, tq = jnp.asarray(q), torch.from_numpy(q)
        tol = F32_TOL
    for n in (0, 1, 77, S):
        want = np.asarray(jax_flash_decode(jq, jk, jv, n, jks, jvs, group=G,
                                           bk=64, interpret=True)).astype(
            np.float32)
        ok = torch.arange(S)[None, :] < n
        got = tc_decode(tq.float()[None], tk.float(), tv.float(), ok, rps,
                        *scales, q_split=q_dt == "f32")[0]
        got = got.to(tq.dtype).float().numpy()
        np.testing.assert_allclose(got, want, **tol, err_msg=f"kv_len {n}")
        plain = FDK.flash_decode_plain(tq, tk, tv, n, tks, tvs, group=G)
        np.testing.assert_allclose(plain.float().numpy(), want, **tol)
        if n == 0:
            assert not got.any()


def tc_fused_decode(params, x, cache, pos, cfg, a_q, a_kv, rps):
    """The fused decode's kernels on a bf16 or int8 cache: f32 QKV from the
    f32 masters (gemv.cuh's exact-f32 route: an f32 product up to order),
    RoPE and the quantize round trip as the plain version does them, the
    attention by the core (one unit per (slot, KV head), the extension
    column merged with the splits), the f32 output projection. Returns the
    output and the cache it writes (a copy)."""
    B = x.shape[0]
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    G = H // KV
    xf = x[:, 0].float()

    def gate(y, a):
        cols = torch.arange(y.shape[-1])[None, :]
        return torch.where(cols < a[:, None], y, torch.zeros(()))

    q = gate(xf @ params["wq"], a_q).view(B, H, hd)
    kn = gate(xf @ params["wk"], a_kv).view(B, KV, hd)
    vn = gate(xf @ params["wv"], a_kv).view(B, KV, hd)
    q = FD._rope_rows(q, pos, cfg.rope_theta)
    kn = FD._rope_rows(kn, pos, cfg.rope_theta)
    out_cache = {n: t.clone() for n, t in cache.items()}
    S = cache["k"].shape[1]
    if cfg.kv_quant:
        ksc = kn.abs().amax(-1, keepdim=True) / 127.0
        vsc = vn.abs().amax(-1, keepdim=True) / 127.0
        kq = torch.round(kn / torch.clamp(ksc, min=1e-8))
        vq = torch.round(vn / torch.clamp(vsc, min=1e-8))
        ke = kq * ksc.bfloat16().float()
        ve = vq * vsc.bfloat16().float()
        k_st, v_st = kq.to(torch.int8), vq.to(torch.int8)
        scales = (cache["k_scale"].float()[..., 0].transpose(1, 2)
                  .reshape(B * KV, S),
                  cache["v_scale"].float()[..., 0].transpose(1, 2)
                  .reshape(B * KV, S))
    else:
        k_st, v_st = kn.bfloat16(), vn.bfloat16()
        ke, ve = k_st.float(), v_st.float()
        scales = (None, None)
    slot, kpos = FD._slot_kpos(pos, S, cfg.sliding_window)
    p = pos.long()[:, None]
    ok = (kpos >= 0) & (kpos <= p)
    if cfg.sliding_window:
        ok &= kpos > p - cfg.sliding_window
    kc = cache["k"].float().transpose(1, 2).reshape(B * KV, S, hd)
    vc = cache["v"].float().transpose(1, 2).reshape(B * KV, S, hd)
    qu = q.view(B * KV, G, hd)
    s_e = (qu * ke.reshape(B * KV, 1, hd)).sum(-1) / math.sqrt(hd)
    o = tc_decode(qu, kc, vc, ok.repeat_interleave(KV, 0), rps, *scales,
                  ext=(s_e, ve.reshape(B * KV, hd)))
    o = gate(o.reshape(B, H * hd), a_q)
    out = (o @ params["wo"]).to(x.dtype)[:, None, :]
    bix = torch.arange(B)
    out_cache["k"][bix, slot] = k_st
    out_cache["v"][bix, slot] = v_st
    if cfg.kv_quant:
        out_cache["k_scale"][bix, slot] = ksc.bfloat16()
        out_cache["v_scale"][bix, slot] = vsc.bfloat16()
    return out, out_cache


@pytest.mark.parametrize("variant", ["bf16", "int8", "swa_bf16", "swa_int8"])
def test_tc_fused_decode_emulation_matches_pallas(variant):
    """fused_decode_step on the smoke config (G = 2, hd 16) at mixed widths
    over a 160-row cache (three 64-row splits; with a sliding window of 80
    the ring is 80 rows, two splits, and the last slot's position wraps):
    bf16 activations and cache, or f32 activations over an int8 cache. The
    core's arithmetic against the Pallas kernel in interpret mode, output
    and written cache (int8 values exact)."""
    kw = {"bf16": {"dtype": "bfloat16"}, "int8": {"kv_quant": True},
          "swa_bf16": {"dtype": "bfloat16", "sliding_window": 80},
          "swa_int8": {"kv_quant": True, "sliding_window": 80}}[variant]
    jcfg = dataclasses.replace(jax_smoke_config("tinyllama-1.1b"), **kw)
    tcfg = dataclasses.replace(smoke_config("tinyllama-1.1b"), **kw)
    rng = np.random.default_rng(len(variant))
    dm, H, KV, hd, B = tcfg.d_model, tcfg.n_heads, tcfg.n_kv_heads, \
        tcfg.head_dim, 3
    params = {n: (rng.standard_normal(sh) / np.sqrt(sh[0])).astype(np.float32)
              for n, sh in (("wq", (dm, H * hd)), ("wk", (dm, KV * hd)),
                            ("wv", (dm, KV * hd)), ("wo", (H * hd, dm)))}
    S = tcfg.sliding_window or 160
    shape = (B, S, KV, hd)
    x = rng.standard_normal((B, 1, dm)).astype(np.float32)
    if tcfg.kv_quant:
        k = rng.integers(-127, 128, shape).astype(np.int8)
        v = rng.integers(-127, 128, shape).astype(np.int8)
        ks = rng.uniform(0.001, 0.02, shape[:-1] + (1,)).astype(np.float32)
        vs = rng.uniform(0.001, 0.02, shape[:-1] + (1,)).astype(np.float32)
        jc = {"k": jnp.asarray(k), "v": jnp.asarray(v),
              "k_scale": jnp.asarray(ks).astype(jnp.bfloat16),
              "v_scale": jnp.asarray(vs).astype(jnp.bfloat16)}
        tc = {"k": torch.from_numpy(k), "v": torch.from_numpy(v),
              "k_scale": torch.from_numpy(ks).bfloat16(),
              "v_scale": torch.from_numpy(vs).bfloat16()}
        jx, tx = jnp.asarray(x), torch.from_numpy(x)
        tol = F32_TOL
    else:
        k = rng.standard_normal(shape).astype(np.float32)
        v = rng.standard_normal(shape).astype(np.float32)
        (jk, tk), (jv, tv) = _bf16(k), _bf16(v)
        jc, tc = {"k": jk, "v": jv}, {"k": tk, "v": tv}
        jx, tx = _bf16(x)
        tol = BF16_TOL
    pos = np.array([0, 70, S + 100], np.int32)
    a_q = np.array([32, 64, 24], np.int32)
    a_kv = np.array([16, 32, 24], np.int32)
    o_j, c_j = JFD.fused_decode_step(
        {n: jnp.asarray(w) for n, w in params.items()}, jx, jc,
        jnp.asarray(pos), jcfg,
        active={"q_dim": jnp.asarray(a_q), "kv_dim": jnp.asarray(a_kv)},
        impl="pallas", interpret=True)
    o_t, c_t = tc_fused_decode(
        {n: torch.from_numpy(w) for n, w in params.items()}, tx, tc,
        torch.from_numpy(pos), tcfg, torch.from_numpy(a_q),
        torch.from_numpy(a_kv), rps=64)
    np.testing.assert_allclose(o_t.float().numpy(),
                               np.asarray(o_j).astype(np.float32), **tol)
    for n in tc:
        got = c_t[n].float().numpy()
        want = np.asarray(c_j[n]).astype(np.float32)
        if c_t[n].dtype == torch.int8:
            np.testing.assert_array_equal(got, want, err_msg=n)
        else:
            np.testing.assert_allclose(got, want, **BF16_TOL, err_msg=n)


# ---------------------------------------------------------------------------
# the verify problem on the decode-attention core
# ---------------------------------------------------------------------------


def tc_fused_verify(params, x, cache, pos, cfg, a_q, a_kv, node_depth,
                    tree_bias, rps=64):
    """fused_verify's kernels on a bf16 or int8 cache: f32 QKV from the f32
    masters (an f32 product up to order), RoPE at each row's own position,
    the raw candidates, the extension keys (through the int8 round trip
    with the bf16-rounded scale on an int8 cache), then the attention by the
    core: one unit per (slot, KV head) whose G*S rows (g-major, then s) are
    one block's m16 row tiles, each row's own visibility, the S extension
    columns in f32 under ext_ok; the f32 output projection. Returns (out,
    {"k", "v"})."""
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    G = H // KV
    offs, ext_ok = FD.verify_operands(S, node_depth, tree_bias,
                                      cfg.sliding_window, "cpu")
    qpos = pos.long()[:, None] + offs.long()[None, :]  # (B, S)
    xf = x.float()

    def gate(y, a):
        cols = torch.arange(y.shape[-1])[None, None, :]
        return torch.where(cols < a[:, None, None], y, torch.zeros(()))

    q = gate(xf @ params["wq"], a_q).view(B * S, H, hd)
    kn = gate(xf @ params["wk"], a_kv).view(B * S, KV, hd)
    vn = gate(xf @ params["wv"], a_kv).view(B, S, KV, hd)
    q = FD._rope_rows(q, qpos.reshape(-1), cfg.rope_theta).view(B, S, H, hd)
    kn = FD._rope_rows(kn, qpos.reshape(-1), cfg.rope_theta).view(B, S, KV,
                                                                  hd)
    Sc = cache["k"].shape[1]
    if cfg.kv_quant:
        def trip(t):
            sc = t.abs().amax(-1, keepdim=True) / 127.0
            return (torch.round(t / torch.clamp(sc, min=1e-8))
                    * sc.bfloat16().float())
        ke, ve = trip(kn), trip(vn)
        scales = tuple(cache[n].float()[..., 0].transpose(1, 2)
                       .reshape(B * KV, Sc) for n in ("k_scale", "v_scale"))
    else:
        ke, ve = kn, vn
        scales = (None, None)
    kpos = _cache_kpos(pos, Sc, cfg.sliding_window)  # (B, Sc)
    qp = qpos[:, :, None]
    ok = (kpos[:, None, :] >= 0) & (kpos[:, None, :] <= qp)
    if cfg.sliding_window:
        ok &= kpos[:, None, :] > qp - cfg.sliding_window
    # units (b, h); rows r = g * S + s
    qu = q.view(B, S, KV, G, hd).permute(0, 2, 3, 1, 4).reshape(B * KV,
                                                                G * S, hd)
    oku = ok[:, None, None].expand(B, KV, G, S, Sc).reshape(B * KV, G * S,
                                                            Sc)
    keu = ke.permute(0, 2, 1, 3).reshape(B * KV, S, hd)
    veu = ve.permute(0, 2, 1, 3).reshape(B * KV, S, hd)
    s_e = qu @ keu.transpose(1, 2) / math.sqrt(hd)  # (U, G*S, S) in f32
    eok = ext_ok.bool()[None, None].expand(B * KV, G, S, S).reshape(
        B * KV, G * S, S)
    kc = cache["k"].float().transpose(1, 2).reshape(B * KV, Sc, hd)
    vc = cache["v"].float().transpose(1, 2).reshape(B * KV, Sc, hd)
    o = tc_decode(qu, kc, vc, oku, rps, *scales, ext=(s_e, eok, veu))
    o = o.view(B, KV, G, S, hd).permute(0, 3, 1, 2, 4).reshape(B, S, H * hd)
    out = (gate(o, a_q) @ params["wo"]).to(x.dtype)
    return out, {"k": kn.to(x.dtype), "v": vn.to(x.dtype)}


@pytest.mark.parametrize("variant", ["linear_bf16", "tree_int8",
                                     "swa_linear_bf16"])
def test_tc_fused_verify_emulation_matches_pallas(variant):
    """fused_verify at 16 query heads over 2 KV heads (G * S = 40 rows for
    S = 5, 56 for the (2, 2) tree: three and four m16 row tiles of one
    block), hd 16, mixed widths and positions: a bf16 cache of 160 rows
    (three 64-row splits) with the linear mask; an int8 cache with the
    tree's ancestor mask; and a sliding window of 40 over a 40-row ring
    (the last slot wrapped), whose lower edge differs between the rows of
    one block. The core's arithmetic against the Pallas kernel in interpret
    mode, output and candidates."""
    kw = {"linear_bf16": {"dtype": "bfloat16"},
          "tree_int8": {"kv_quant": True},
          "swa_linear_bf16": {"dtype": "bfloat16", "sliding_window": 40},
          }[variant]
    kw.update(n_heads=16, n_kv_heads=2)
    jcfg = dataclasses.replace(jax_smoke_config("tinyllama-1.1b"), **kw)
    tcfg = dataclasses.replace(smoke_config("tinyllama-1.1b"), **kw)
    rng = np.random.default_rng(len(variant) + 17)
    dm, H, KV, hd, B = tcfg.d_model, tcfg.n_heads, tcfg.n_kv_heads, \
        tcfg.head_dim, 3
    assert H // KV == 8
    params = {n: (rng.standard_normal(sh) / np.sqrt(sh[0])).astype(np.float32)
              for n, sh in (("wq", (dm, H * hd)), ("wk", (dm, KV * hd)),
                            ("wv", (dm, KV * hd)), ("wo", (H * hd, dm)))}
    nd = tb = None
    S = 5
    if variant.startswith("tree"):
        topo = tree_topology((2, 2))
        nd, tb = topo.depths, topo.ancestor_bias
        S = len(nd)
    Sc = tcfg.sliding_window or 160
    shape = (B, Sc, KV, hd)
    x = rng.standard_normal((B, S, dm)).astype(np.float32)
    if tcfg.kv_quant:
        k = rng.integers(-127, 128, shape).astype(np.int8)
        v = rng.integers(-127, 128, shape).astype(np.int8)
        ks = rng.uniform(0.001, 0.02, shape[:-1] + (1,)).astype(np.float32)
        vs = rng.uniform(0.001, 0.02, shape[:-1] + (1,)).astype(np.float32)
        jc = {"k": jnp.asarray(k), "v": jnp.asarray(v),
              "k_scale": jnp.asarray(ks).astype(jnp.bfloat16),
              "v_scale": jnp.asarray(vs).astype(jnp.bfloat16)}
        tc = {"k": torch.from_numpy(k), "v": torch.from_numpy(v),
              "k_scale": torch.from_numpy(ks).bfloat16(),
              "v_scale": torch.from_numpy(vs).bfloat16()}
        jx, tx = jnp.asarray(x), torch.from_numpy(x)
    else:
        k = rng.standard_normal(shape).astype(np.float32)
        v = rng.standard_normal(shape).astype(np.float32)
        (jk, tk), (jv, tv) = _bf16(k), _bf16(v)
        jc, tc = {"k": jk, "v": jv}, {"k": tk, "v": tv}
        jx, tx = _bf16(x)
    pos = np.array([0, 70, Sc + 73], np.int32)
    a_q = np.array([64, 256, 96], np.int32)
    a_kv = np.array([16, 32, 24], np.int32)
    # one compiled executable (not one per eager op): the suite's workers
    # run many modules in one process, and XLA's compiler state adds up
    o_j, kv_j = jax.jit(lambda prm, xx, c, ps, act: JFD.fused_verify(
        prm, xx, c, ps, jcfg, active=act, node_depth=nd, tree_bias=tb,
        impl="pallas", interpret=True))(
        {n: jnp.asarray(w) for n, w in params.items()}, jx, jc,
        jnp.asarray(pos),
        {"q_dim": jnp.asarray(a_q), "kv_dim": jnp.asarray(a_kv)})
    o_t, kv_t = tc_fused_verify(
        {n: torch.from_numpy(w) for n, w in params.items()}, tx, tc,
        torch.from_numpy(pos), tcfg, torch.from_numpy(a_q),
        torch.from_numpy(a_kv), nd, tb)
    np.testing.assert_allclose(o_t.float().numpy(),
                               np.asarray(o_j).astype(np.float32), **BF16_TOL)
    for n in ("k", "v"):
        np.testing.assert_allclose(kv_t[n].float().numpy(),
                                   np.asarray(kv_j[n]).astype(np.float32),
                                   **BF16_TOL, err_msg=n)


# ---------------------------------------------------------------------------
# ssd_scan: tiles in parallel, then the carry, products in 3xTF32
# ---------------------------------------------------------------------------


def tf32(a: torch.Tensor) -> torch.Tensor:
    """f32 rounded to tf32 as cvt.rna.tf32.f32 does: 10 mantissa bits,
    nearest, ties away from zero."""
    i = a.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def mm3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as 3xTF32: a_lo b_hi + a_hi b_lo + a_hi b_hi, f32 sums."""
    ah, bh = tf32(a), tf32(b)
    al, bl = tf32(a - ah), tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def tc_ssd_scan(x, dt, A, B_, C_, L=64):
    """The scan kernels' arithmetic in the model layout: x (b, s, h, p), dt
    (b, s, h), A (h,), B_ and C_ (b, s, g, n), f32. 64-step tiles (a ragged
    last one zero-filled: dt = 0 and x = 0); launch 1 the tiles' state
    contributions (u o decay)^T B and exp(cs_last) per (batch, head, tile)
    and C.B^T once per (batch, group, tile); launch 2 the carry in f32;
    launch 3 y = (C.B^T o L) u + exp(cs) C state^T per tile. Returns (y,
    final state (b, h, p, n))."""
    b, s, h, p = x.shape
    g, n = B_.shape[2], B_.shape[3]
    T = -(-s // L)
    pad = T * L - s
    x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
    dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
    B_ = torch.nn.functional.pad(B_, (0, 0, 0, 0, 0, pad))
    C_ = torch.nn.functional.pad(C_, (0, 0, 0, 0, 0, pad))
    y = torch.zeros(b, T * L, h, p)
    state = torch.zeros(b, h, p, n)
    tri = torch.tril(torch.ones(L, L, dtype=torch.bool))
    for bi in range(b):
        for hi in range(h):
            gi = hi // (h // g)
            st, el, cbs, css = [], [], [], []
            for c in range(T):  # launch 1, every tile on its own
                sl = slice(c * L, (c + 1) * L)
                Bt, Ct = B_[bi, sl, gi], C_[bi, sl, gi]
                d = dt[bi, sl, hi]
                cs = torch.cumsum(d * A[hi], 0)
                w = torch.exp(cs[-1] - cs) * d
                st.append(mm3((w[:, None] * x[bi, sl, hi]).T, Bt))
                el.append(torch.exp(cs[-1]))
                cbs.append(mm3(Ct, Bt.T))  # once per (batch, group, tile)
                css.append(cs)
            prev = [torch.zeros(p, n)]  # launch 2
            for c in range(T):
                prev.append(el[c] * prev[c] + st[c])
            state[bi, hi] = prev[T]
            for c in range(T):  # launch 3
                sl = slice(c * L, (c + 1) * L)
                cs = css[c]
                Lm = torch.where(tri, torch.exp(cs[:, None] - cs[None, :]),
                                 torch.zeros(()))
                M = torch.where(tri, cbs[c] * Lm, torch.zeros(()))
                u = dt[bi, sl, hi][:, None] * x[bi, sl, hi]
                y[bi, sl, hi] = (mm3(M, u) + torch.exp(cs)[:, None]
                                 * mm3(C_[bi, sl, gi], prev[c].T))
    return y[:, :s], state


@pytest.mark.parametrize("shape,chunk", [((2, 150, 4, 16, 2, 16), 50),
                                         ((1, 128, 2, 8, 1, 32), 64)])
def test_tc_ssd_scan_emulation_matches_pallas(shape, chunk):
    """The scan kernels' decomposition and 3xTF32 products at a ragged S =
    150 (tiles of 64, 64 and 22) with two groups, and at two whole tiles,
    against the Pallas ``ssd_scan`` in interpret mode (the kernel's own
    layout: one head per row, B and C repeated) and against the port's and
    JAX's ``ssd_chunked`` in the model layout, rtol 1e-4 + atol 1e-4."""
    b, s, h, p, g, n = shape
    rng = np.random.default_rng(s + n)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)) - 2.0)).astype(
        np.float32)
    A = -np.exp(rng.uniform(0, 2.7, h)).astype(np.float32)
    B_ = rng.standard_normal((b, s, g, n)).astype(np.float32)
    C_ = rng.standard_normal((b, s, g, n)).astype(np.float32)
    tol = dict(rtol=1e-4, atol=1e-4)
    y, st = tc_ssd_scan(*map(torch.from_numpy, (x, dt, A, B_, C_)))
    yp, stp = TSSD.ssd_chunked(*map(torch.from_numpy, (x, dt, A, B_, C_)),
                               64)
    np.testing.assert_allclose(y.numpy(), yp.numpy(), **tol)
    np.testing.assert_allclose(st.numpy(), stp.numpy(), **tol)
    jy, jst = jax.jit(JSSM.ssd_chunked, static_argnums=5)(
        *map(jnp.asarray, (x, dt, A, B_, C_)), chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **tol)
    np.testing.assert_allclose(st.numpy(), np.asarray(jst), **tol)
    rep_ = h // g
    flat = (x.transpose(0, 2, 1, 3).reshape(b * h, s, p),
            dt.transpose(0, 2, 1).reshape(b * h, s),
            np.broadcast_to(A, (b, h)).reshape(b * h),
            *(np.repeat(t, rep_, axis=2).transpose(0, 2, 1, 3)
              .reshape(b * h, s, n) for t in (B_, C_)))
    ky, kst = jax.jit(lambda *a: jax_ssd_scan(*a, chunk=chunk,
                                              interpret=True))(
        *map(jnp.asarray, flat))
    np.testing.assert_allclose(
        y.numpy().transpose(0, 2, 1, 3).reshape(b * h, s, p), np.asarray(ky),
        **tol)
    np.testing.assert_allclose(st.numpy().reshape(b * h, p, n),
                               np.asarray(kst), **tol)
