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
* ``fused_verify``: linear and token-tree masks, f32 / bf16 / int8 caches,
  a sliding window, mixed widths, against the Pallas verify kernel and the
  unfused reference (f32 atol 1e-5; bf16 within one bf16 step).
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
from torch_threads import one_thread  # noqa: E402,F401  (autouse)

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


# fused_verify: linear and token-tree masks (the tree is JAX's own (2, 2)
# topology: S = 7 nodes, depths and ancestor mask), f32 / bf16 activations
# with a cache of the same dtype, and int8 caches; mixed widths.
FV_VARIANTS = {
    "linear_f32": ({}, False),
    "tree_f32": ({}, True),
    "linear_int8": ({"kv_quant": True}, False),
    "tree_int8": ({"kv_quant": True}, True),
    "linear_swa": ({"sliding_window": 6}, False),
    "linear_bf16": ({"dtype": "bfloat16"}, False),
}


def _fv_operands(variant, seed=3, B=3, Sc=16):
    from repro.runtime.speculative import tree_topology

    kw, tree = FV_VARIANTS[variant]
    jcfg = dataclasses.replace(jax_smoke_config("tinyllama-1.1b"), **kw)
    tcfg = dataclasses.replace(smoke_config("tinyllama-1.1b"), **kw)
    _, _, params, _, cache, _, a_q, a_kv = _fd_operands(
        "kv_quant" if jcfg.kv_quant else "full", seed, B=B, S=Sc)
    if jcfg.sliding_window:
        cache = {k: v[:, :jcfg.sliding_window] for k, v in cache.items()}
        Sc = jcfg.sliding_window
    if tree:
        topo = tree_topology((2, 2))
        nd, tb = topo.depths, topo.ancestor_bias
    else:
        nd = tb = None
    S = 7 if tree else 5
    rng = np.random.default_rng(seed + 10)
    x = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    # committed counts: empty, mid-cache, and a full (or wrapped) cache
    pos = np.array([0, 6, Sc + 2 if jcfg.sliding_window else Sc - S],
                   np.int32)[:B]
    return jcfg, tcfg, params, x, cache, pos, a_q, a_kv, nd, tb


@pytest.mark.parametrize("variant", sorted(FV_VARIANTS))
def test_fused_verify_plain_matches_pallas_and_ref(variant):
    """``fused_verify_plain`` vs the Pallas verify kernel in interpret mode
    and (f32) vs the unfused reference ``impl="ref"``: f32 atol 1e-5 (rtol
    1e-5), bf16 activations within one bf16 step (rtol 2^-7, atol 1e-3)."""
    jcfg, tcfg, params, x, cache, pos, a_q, a_kv, nd, tb = _fv_operands(variant)
    bf16 = jcfg.dtype == "bfloat16"
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    tdt = torch.bfloat16 if bf16 else torch.float32
    jc = _jax_cache(cache)
    if bf16:
        jc = {k: v.astype(jnp.bfloat16) for k, v in jc.items()}
    jargs = ({k: jnp.asarray(v) for k, v in params.items()},
             jnp.asarray(x, jdt), jc, jnp.asarray(pos),
             {"q_dim": jnp.asarray(a_q), "kv_dim": jnp.asarray(a_kv)})
    tc = {k: torch.from_numpy(np.asarray(v, np.float32)).to(
        torch.bfloat16) if k.endswith("scale") else torch.from_numpy(
        np.asarray(v).copy()) for k, v in cache.items()}
    if bf16:
        tc = {k: v.to(torch.bfloat16) for k, v in tc.items()}
    tc0 = {k: v.clone() for k, v in tc.items()}
    o_t, kv_t = FD.fused_verify(
        {k: torch.from_numpy(v) for k, v in params.items()},
        torch.from_numpy(x).to(tdt), tc, torch.from_numpy(pos), tcfg,
        active={"q_dim": torch.from_numpy(a_q),
                "kv_dim": torch.from_numpy(a_kv)}, node_depth=nd,
        tree_bias=tb)
    for k in tc:  # read only
        assert torch.equal(tc[k], tc0[k]), k
    impls = ("pallas",) if bf16 else ("pallas", "ref")
    tol = dict(atol=1e-3, rtol=2.0 ** -7) if bf16 else dict(atol=1e-5,
                                                            rtol=1e-5)
    for impl in impls:
        kw = dict(interpret=True) if impl == "pallas" else {}
        # jitted: one compile instead of op-by-op dispatch (the topology is
        # static, closed over as numpy)
        o_j, kv_j = jax.jit(lambda p, x_, c, pos_, act, impl=impl, kw=kw:
                            JFD.fused_verify(p, x_, c, pos_, jcfg,
                                             active=act, node_depth=nd,
                                             tree_bias=tb, impl=impl,
                                             **kw))(*jargs)
        np.testing.assert_allclose(o_t.float().numpy(),
                                   np.asarray(o_j, np.float32), **tol,
                                   err_msg=f"{variant} {impl} out")
        for k in ("k", "v"):
            np.testing.assert_allclose(kv_t[k].float().numpy(),
                                       np.asarray(kv_j[k], np.float32), **tol,
                                       err_msg=f"{variant} {impl} {k}")
    assert FD.verify_launch_count() == 0


def test_fused_verify_raises_until_its_slice():
    """The paged slice has landed: fused_verify over a page pool read
    through an identity table equals it over the dense cache with the same
    contents (``tests/test_torch_paged.py`` holds shuffled tables to the
    Pallas kernel), and a table of the wrong width for the pool raises."""
    jcfg, tcfg, params, x, cache, pos, a_q, a_kv, nd, tb = _fv_operands(
        "linear_f32")
    B, Sc = cache["k"].shape[:2]
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    act = {"q_dim": torch.from_numpy(a_q), "kv_dim": torch.from_numpy(a_kv)}
    dense = {k: torch.from_numpy(np.array(v)) for k, v in cache.items()}
    ps = 4
    pool = {k: v.reshape((B * Sc // ps, ps) + tuple(v.shape[2:]))
            for k, v in dense.items()}
    table = torch.arange(B * Sc // ps, dtype=torch.int32).view(B, Sc // ps)
    o_d, kv_d = FD.fused_verify(tp, torch.from_numpy(x), dense,
                                torch.from_numpy(pos), tcfg, active=act)
    o_p, kv_p = FD.fused_verify(tp, torch.from_numpy(x), pool,
                                torch.from_numpy(pos), tcfg, active=act,
                                pages=table, page_size=ps)
    assert torch.equal(o_d, o_p)
    assert all(torch.equal(kv_d[k], kv_p[k]) for k in kv_d)
    with pytest.raises(IndexError):
        FD.fused_verify(tp, torch.from_numpy(x), pool, torch.from_numpy(pos),
                        tcfg, active=act, pages=table + B * Sc, page_size=ps)


def test_ext_mask_matches_jax():
    from repro.runtime.speculative import tree_topology

    topo = tree_topology((2, 2))
    for offs, tb, window in ((np.arange(5), None, 0), (np.arange(5), None, 3),
                             (topo.depths, topo.ancestor_bias, 0),
                             (topo.depths, topo.ancestor_bias, 2)):
        np.testing.assert_array_equal(FD.ext_mask_np(offs, window, tb),
                                      JFD._ext_mask_np(offs, window, tb))
