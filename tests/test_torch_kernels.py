"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU each ``repro_torch`` kernel wrapper runs its plain PyTorch
version (the CUDA kernels themselves are held to those plain versions on the
card by ``test_torch_cuda.py`` and ``chip_smoke.py``). Here the plain
versions are held to the Pallas kernels in interpret mode, on the same numpy
inputs, in f32:

* ``morph_matmul``: per-batch ``active_n`` / ``active_k``, widths that are
  not tile-aligned, dims that do not divide the tiles; atol = rtol = 1e-5,
  and columns at or past ``active_n`` exactly zero.
* ``fused_decode_step``: plain, sliding-window and int8-KV variants with
  mixed widths on a dense cache, at the JAX test's own tolerance
  (atol 2e-5, rtol 1e-4, ``tests/test_fused_decode.py``); the output and the
  new K/V and scales written into the cache match, int8 values exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.kernels import fused_decode as JFD
from repro.kernels.morph_matmul import morph_matmul as jax_morph_matmul
from repro_torch.configs import smoke_config
from repro_torch.kernels import fused_decode as FD
from repro_torch.kernels import morph_matmul as MM
from repro_torch.kernels.ref import morph_matmul_ref

MM_CASES = {
    # (B, M, K, N), block, active_n, active_k
    "decode_gemv": ((3, 1, 64, 96), (128, 128, 128), [96, 40, 17], [64, 64, 64]),
    "ragged_tiles": ((3, 5, 70, 45), (8, 32, 16), [45, 13, 0], [70, 33, 5]),
    "k_gate_only": ((2, 3, 48, 40), (8, 16, 16), None, [20, 48]),
}


@pytest.mark.parametrize("case", sorted(MM_CASES))
def test_morph_matmul_plain_matches_pallas(case):
    (B, M, K, N), block, an, ak = MM_CASES[case]
    rng = np.random.default_rng(hash(case) % 2**32)
    x = rng.standard_normal((B, M, K)).astype(np.float32)
    w = rng.standard_normal((K, N)).astype(np.float32)
    an_j = None if an is None else jnp.asarray(an, jnp.int32)
    ak_j = None if ak is None else jnp.asarray(ak, jnp.int32)
    want = np.asarray(jax_morph_matmul(jnp.asarray(x), jnp.asarray(w), an_j,
                                       ak_j, block=block, interpret=True,
                                       impl="pallas"))
    an_t = None if an is None else torch.tensor(an, dtype=torch.int32)
    ak_t = None if ak is None else torch.tensor(ak, dtype=torch.int32)
    got = MM.morph_matmul(torch.from_numpy(x), torch.from_numpy(w), an_t, ak_t)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    for b in range(B):
        if an is not None:
            assert np.all(got.numpy()[b, :, an[b]:] == 0.0)
    # the oracle port agrees too (per-batch slicing, not masking)
    ref = morph_matmul_ref(torch.from_numpy(x), torch.from_numpy(w), an, ak)
    np.testing.assert_allclose(ref.numpy(), want, atol=1e-5, rtol=1e-5)


def test_morph_matmul_scalar_widths_and_2d():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((4, 33)).astype(np.float32)
    w = rng.standard_normal((33, 20)).astype(np.float32)
    want = np.asarray(jax_morph_matmul(jnp.asarray(x), jnp.asarray(w), 11, 30,
                                       interpret=True, impl="pallas"))
    got = MM.morph_matmul(torch.from_numpy(x), torch.from_numpy(w), 11, 30)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    assert MM.launch_count() == 0  # the CPU never launches the kernel


FD_VARIANTS = {
    "full": {},
    "swa": {"sliding_window": 6},
    "kv_quant": {"kv_quant": True},
}


def _fd_operands(variant, seed, B=3, S=16):
    kw = FD_VARIANTS[variant]
    jcfg = dataclasses.replace(jax_smoke_config("tinyllama-1.1b"), **kw)
    tcfg = dataclasses.replace(smoke_config("tinyllama-1.1b"), **kw)
    rng = np.random.default_rng(seed)
    dm, H, KV, hd = jcfg.d_model, jcfg.n_heads, jcfg.n_kv_heads, jcfg.head_dim
    s = 1.0 / np.sqrt(dm)
    params = {
        "wq": rng.standard_normal((dm, H * hd)) * s,
        "wk": rng.standard_normal((dm, KV * hd)) * s,
        "wv": rng.standard_normal((dm, KV * hd)) * s,
        "wo": rng.standard_normal((H * hd, dm)) / np.sqrt(H * hd),
    }
    params = {k: v.astype(np.float32) for k, v in params.items()}
    x = rng.standard_normal((B, 1, dm)).astype(np.float32)
    Sc = min(S, jcfg.sliding_window) if jcfg.sliding_window else S
    shape = (B, Sc, KV, hd)
    if jcfg.kv_quant:
        cache = {"k": rng.integers(-127, 128, shape).astype(np.int8),
                 "v": rng.integers(-127, 128, shape).astype(np.int8),
                 "k_scale": rng.uniform(0.001, 0.02, shape[:-1] + (1,)),
                 "v_scale": rng.uniform(0.001, 0.02, shape[:-1] + (1,))}
    else:
        cache = {"k": rng.standard_normal(shape).astype(np.float32),
                 "v": rng.standard_normal(shape).astype(np.float32)}
    # positions: empty cache, mid-cache, a full (or wrapped) cache
    pos = np.array([0, 5, Sc + 3], np.int32)[:B]
    # mixed widths: 0.5 / 1.0 and one gate that is not head-aligned
    a_q = np.array([32, 64, 24], np.int32)[:B]
    a_kv = np.array([16, 32, 24], np.int32)[:B]
    return jcfg, tcfg, params, x, cache, pos, a_q, a_kv


def _jax_cache(cache):
    out = {}
    for k, v in cache.items():
        out[k] = jnp.asarray(v, jnp.bfloat16) if k.endswith("scale") else \
            jnp.asarray(v)
    return out


@pytest.mark.parametrize("variant", sorted(FD_VARIANTS))
def test_fused_decode_plain_matches_pallas(variant):
    for seed in (0, 1):
        jcfg, tcfg, params, x, cache, pos, a_q, a_kv = _fd_operands(variant, seed)
        jc = _jax_cache(cache)
        o_j, c_j = JFD.fused_decode_step(
            {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x),
            jc, jnp.asarray(pos), jcfg,
            active={"q_dim": jnp.asarray(a_q), "kv_dim": jnp.asarray(a_kv)},
            impl="pallas", interpret=True)
        tc = {k: torch.from_numpy(np.asarray(jax.device_get(v), np.float32)).to(
            torch.bfloat16) if k.endswith("scale") else torch.from_numpy(
            np.asarray(v).copy()) for k, v in cache.items()}
        o_t, c_t = FD.fused_decode_step(
            {k: torch.from_numpy(v) for k, v in params.items()},
            torch.from_numpy(x), tc, torch.from_numpy(pos), tcfg,
            active={"q_dim": torch.from_numpy(a_q),
                    "kv_dim": torch.from_numpy(a_kv)})
        assert c_t is tc  # written in place
        np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j),
                                   atol=2e-5, rtol=1e-4,
                                   err_msg=f"{variant} seed{seed} out")
        for k in cache:
            got = c_t[k].float().numpy()
            want = np.asarray(c_j[k], np.float32)
            if c_t[k].dtype == torch.int8:
                np.testing.assert_array_equal(got, want,
                                              err_msg=f"{variant} {k}")
            else:
                np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4,
                                           err_msg=f"{variant} seed{seed} {k}")
    assert FD.launch_count() == 0


def test_fused_verify_raises_until_its_slice():
    with pytest.raises(NotImplementedError, match="speculative"):
        FD.fused_verify(None, None, None, None, None)
