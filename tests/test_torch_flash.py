"""The port's flash kernels' plain versions against the JAX package, on the CPU.

Inputs come from numpy seeds and go to both packages. Pallas kernels run in
interpret mode, as ``tests/test_kernels.py`` and
``tests/test_flash_decode.py`` run them. Tolerances:

* flash attention, f32: atol / rtol 1e-5 against the Pallas kernel at the
  same tiles (the same loop; the products sum in another order) and 1e-5
  against the one-softmax oracle;
* flash attention, bf16 inputs: the output is rounded to bf16 on both
  sides, so they may differ by one bf16 step: rtol 2^-7 + atol 1e-3
  (the f32 products and the f32 softmax agree to 1e-5 before rounding);
* flash decode: atol 1e-5, rtol 1e-5 in f32, int8 caches included (both
  sides dequantize the same int8 values and bf16 scales);
* the chunked prompt pass (smoke config, f32): logits and caches to atol
  1e-4, as ``tests/test_torch_model.py`` holds the einsum prompt pass.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.kernels import ops as JOPS
from repro.kernels import ref as JREF
from repro.kernels.flash_decode import flash_decode as jax_flash_decode
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch.configs import smoke_config
from repro_torch.convert import params_from_jax, to_numpy
from repro_torch.kernels import decode_attn as TDA
from repro_torch.kernels import flash_attention as TFA
from repro_torch.kernels import flash_decode as TFD
from repro_torch.kernels import ops as TOPS
from repro_torch.kernels import ref as TREF
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from torch_threads import one_thread  # noqa: E402,F401  (autouse)

F32_TOL = dict(atol=1e-5, rtol=1e-5)
BF16_TOL = dict(atol=1e-3, rtol=2.0 ** -7)


def _np(*shapes, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _both(a, dtype):
    """One numpy array as a JAX array and a torch tensor of ``dtype``."""
    jd = jnp.float32 if dtype == "f32" else jnp.bfloat16
    td = torch.float32 if dtype == "f32" else torch.bfloat16
    return jnp.asarray(a).astype(jd), torch.from_numpy(a).to(td)


def _close(got, want, tol=F32_TOL, msg=""):
    np.testing.assert_allclose(to_numpy(got), np.asarray(want, np.float32),
                               err_msg=msg, **tol)


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("sq,h,kv,hd,bq,bk", [(64, 4, 2, 32, 16, 16),
                                              (32, 4, 1, 16, 32, 32)])
def test_flash_attention_bshd_matches_pallas(dtype, sq, h, kv, hd, bq, bk):
    """Causal GQA (group 2 and 4), B = 2, the model-layout wrapper's plain
    route vs the Pallas kernel through JAX's wrapper, at the same tiles."""
    B = 2
    q, k, v = _np((B, sq, h, hd), (B, sq, kv, hd), (B, sq, kv, hd), seed=sq)
    (jq, tq), (jk, tk), (jv, tv) = (_both(a, dtype) for a in (q, k, v))
    want = JOPS.flash_attention_bshd(jq, jk, jv, causal=True, bq=bq, bk=bk,
                                     interpret=True)
    got = TOPS.flash_attention_bshd(tq, tk, tv, causal=True, bq=bq, bk=bk)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    _close(got, want, F32_TOL if dtype == "f32" else BF16_TOL)
    assert TFA.launch_count() == 0  # CPU tensors never reach the kernel


@pytest.mark.parametrize("window", [8, 16])
def test_flash_attention_window_matches_pallas(window):
    """Sliding window with 16-row tiles: the first tile a row visits can be
    wholly masked for it (p = 1 there), and the next live tile's rescale
    by exp(-1e30 - m) = 0 must wipe it out, as in the TPU kernel."""
    q, k, v = _np((1, 64, 2, 32), (1, 64, 2, 32), (1, 64, 2, 32), seed=1)
    want = JOPS.flash_attention_bshd(*(jnp.asarray(a) for a in (q, k, v)),
                                     causal=True, window=window, bq=16,
                                     bk=16, interpret=True)
    got = TOPS.flash_attention_bshd(*(torch.from_numpy(a) for a in (q, k, v)),
                                    causal=True, window=window, bq=16, bk=16)
    assert bool(torch.isfinite(got).all())
    _close(got, want)


@pytest.mark.parametrize("window", [0, 8])
def test_flash_attention_ragged_lengths_match_oracle(window):
    """S = 40 with 16-row tiles: the last query tile and the last key tile
    are cut short. JAX's kernel cannot take it; its oracle can."""
    BKV, group, S, hd = 2, 2, 40, 16
    q, k, v = _np((BKV * group, S, hd), (BKV, S, hd), (BKV, S, hd), seed=2)
    want = JREF.flash_attention_ref(*(jnp.asarray(a) for a in (q, k, v)),
                                    group=group, causal=True, window=window)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = TFA.flash_attention(tq, tk, tv, group=group, causal=True,
                              window=window, bq=16, bk=16)
    _close(got, want)
    ref = TREF.flash_attention_ref(tq, tk, tv, group=group, causal=True,
                                   window=window)
    _close(ref, want)


def test_flash_attention_non_causal_matches_oracle():
    BKV, group, S, hd = 1, 3, 24, 8
    q, k, v = _np((BKV * group, S, hd), (BKV, S, hd), (BKV, S, hd), seed=3)
    want = JREF.flash_attention_ref(*(jnp.asarray(a) for a in (q, k, v)),
                                    group=group, causal=False)
    got = TFA.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                              group=group, causal=False, bq=8, bk=16)
    _close(got, want)


def test_flash_plain_matches_port_attention_chunked():
    """The plain version vs the port's model-zoo chunked attention at the
    tinyllama smoke shapes (the JAX test_flash_matches_model_attention)."""
    cfg = smoke_config("tinyllama-1.1b")
    B, S = 2, 32
    q, k, v = _np((B, S, cfg.n_heads, cfg.head_dim),
                  (B, S, cfg.n_kv_heads, cfg.head_dim),
                  (B, S, cfg.n_kv_heads, cfg.head_dim), seed=4)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    pos = torch.arange(S)
    want = TL.attention_chunked(tq, tk, tv, cfg.scaled(attn_chunk=16), pos,
                                pos)
    got = TOPS.flash_attention_bshd(tq, tk, tv, causal=True, bq=16, bk=16)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("variant", ["full", "swa"])
def test_chunked_prompt_pass_matches_jax(variant):
    """A smoke-config f32 prefill with attn_impl="chunked" (the attention
    the kernel carries on a card), port vs JAX: logits and every cache
    leaf to 1e-4, at full depth and at the first exit."""
    kw = {"attn_impl": "chunked", "attn_chunk": 4}
    if variant == "swa":
        kw["sliding_window"] = 5
    jcfg = dataclasses.replace(jax_smoke_config("tinyllama-1.1b"), **kw)
    tcfg = dataclasses.replace(smoke_config("tinyllama-1.1b"), **kw)
    jp = jax.device_get(JM.init_params(jax.random.PRNGKey(0), jcfg))
    tp = params_from_jax(jp, device="cpu")
    prompt = np.array([[7, 3, 9, 11, 2, 5, 8, 1, 4, 6]], np.int32)
    for depth in (1, jcfg.n_groups):
        jl, jc = JM.prefill(jp, {"tokens": jnp.asarray(prompt)}, jcfg,
                            cache_extra=3, depth=depth)
        tl, tc = TM.prefill(tp, {"tokens": torch.from_numpy(prompt).long()},
                            tcfg, cache_extra=3, depth=depth)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=0)
        for pn, layer in jax.device_get(jc)["stack"].items():
            for name, a in layer.items():
                np.testing.assert_allclose(
                    to_numpy(tc["stack"][pn][name]), np.asarray(a),
                    atol=1e-4, rtol=1e-4, err_msg=f"{pn}/{name}")


def test_flash_attention_launch_needs_cuda():
    q = torch.zeros(1, 4, 2, 8)
    with pytest.raises(ValueError, match="CUDA"):
        TFA.launch(q, q[:, :, :1], q[:, :, :1], torch.empty_like(q),
                   causal=True, window=0)


# ---------------------------------------------------------------------------
# flash decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kv_len", [1, 7, 100, 128])
@pytest.mark.parametrize("group", [1, 4])
def test_flash_decode_matches_pallas(kv_len, group):
    BKV, S, hd = 2, 128, 32
    q, k, v = _np((BKV * group, hd), (BKV, S, hd), (BKV, S, hd),
                  seed=kv_len * 7 + group)
    want = jax_flash_decode(*(jnp.asarray(a) for a in (q, k, v)), kv_len,
                            group=group, bk=32, interpret=True)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = TFD.flash_decode(tq, tk, tv, kv_len, group=group, bk=32)
    _close(got, want)
    # a device scalar (here a CPU tensor) gives the same function
    got_t = TFD.flash_decode(tq, tk, tv, torch.tensor(kv_len,
                                                      dtype=torch.int32),
                             group=group, bk=32)
    torch.testing.assert_close(got_t, got, atol=0, rtol=0)
    ref = TREF.flash_decode_ref(tq, tk, tv, kv_len, group=group)
    _close(ref, want)
    assert TFD.launch_count() == 0


@pytest.mark.parametrize("kv_len", [16, 90, 128])
def test_flash_decode_int8_cache_matches_pallas(kv_len):
    """An int8 cache quantized by each side's own quantize_kv (same int8
    values, same bf16 scales), group 2, a ragged last tile of the plain
    version at bk 48, kv_len as a 1-element tensor."""
    BKV, group, S, hd = 2, 2, 128, 32
    q, kf, vf = _np((BKV * group, hd), (BKV, S, hd), (BKV, S, hd), seed=5)
    jkq, jks = JL.quantize_kv(jnp.asarray(kf))
    jvq, jvs = JL.quantize_kv(jnp.asarray(vf))
    want = jax_flash_decode(jnp.asarray(q), jkq, jvq, kv_len, jks, jvs,
                            group=group, bk=32, interpret=True)
    tkq, tks = TL.quantize_kv(torch.from_numpy(kf))
    tvq, tvs = TL.quantize_kv(torch.from_numpy(vf))
    np.testing.assert_array_equal(tkq.numpy(), np.asarray(jkq))
    np.testing.assert_array_equal(to_numpy(tvs), np.asarray(jvs, np.float32))
    got = TFD.flash_decode(torch.from_numpy(q), tkq, tvq,
                           torch.tensor([kv_len], dtype=torch.int32), tks,
                           tvs, group=group, bk=48)
    _close(got, want)


def test_flash_decode_zero_length_gives_zeros():
    """kv_len = 0: every tile is skipped and the output is 0, as the TPU
    kernel writes it (the oracle would return the mean of v)."""
    q, k, v = _np((4, 16), (2, 64, 16), (2, 64, 16), seed=6)
    want = jax_flash_decode(*(jnp.asarray(a) for a in (q, k, v)), 0,
                            group=2, bk=16, interpret=True)
    got = TFD.flash_decode(*(torch.from_numpy(a) for a in (q, k, v)), 0,
                           group=2, bk=16)
    assert not np.asarray(want).any()
    assert not bool(got.any())


@pytest.mark.parametrize("clusters,S,caps", [
    (32, 512, tuple(396 // s for s in range(1, 17))),   # flash_decode serving
    (32, 1024, tuple(528 // s for s in range(1, 17))),  # fused decode, B = 8
    (32, 1024, (200,) * 7 + (20,) * 9),                 # 16 blocks do not fit
    (2, 128, tuple(396 // s for s in range(1, 17))),
    (1, 1, tuple(396 // s for s in range(1, 17))),
    (1, 0, tuple(396 // s for s in range(1, 17))),
    (64, 4096, tuple(264 // s for s in range(1, 17))),
    (3, 100, (1,) * 16),                                # nothing fits
    (1000, 300, tuple(396 // s for s in range(1, 17))),
])
def test_flash_decode_split_plan_covers_the_cache(clusters, S, caps):
    """The decode-attention core's split plan (shared by flash_decode and
    the fused decode): whole 64-row chunks, every cache row in exactly one
    split, no split past the cache, at most 16 splits (one cluster), and
    more than one split only when every unit's cluster fits on the card at
    once, with no larger split count that would fit as well."""
    splits, rows = TDA.split_plan(clusters, S, caps)
    assert rows % 64 == 0 and 1 <= splits <= 16
    covered = np.zeros(max(S, 1), np.int64)
    for sp in range(splits):
        covered[sp * rows:min((sp + 1) * rows, S)] += 1
        assert sp * rows < max(S, 1)  # no split past the cache
    assert (covered[:S] == 1).all()
    chunks = max(1, -(-S // 64))
    if splits > 1:
        assert caps[splits - 1] >= clusters
    for s in range(splits + 1, min(16, chunks) + 1):
        assert caps[s - 1] < clusters or -(-chunks // -(-chunks // s)) == splits
    if (clusters, S) == (32, 512):
        assert (splits, rows) == (8, 64)  # 256 blocks at the serving shape


def test_flash_decode_launch_needs_cuda():
    q, k = torch.zeros(2, 8), torch.zeros(1, 4, 8)
    with pytest.raises(ValueError, match="CUDA"):
        TFD.launch(q, k, k, 4, group=2)
    with pytest.raises(ValueError, match="int8 cache needs"):
        TFD.flash_decode(q, k.to(torch.int8), k.to(torch.int8), 4, group=2)
