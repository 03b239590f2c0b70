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
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.morph_matmul import morph_matmul as jax_morph_matmul
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import morph_matmul as MM

BF16_TOL = dict(atol=1e-3, rtol=2.0 ** -7)
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
