"""The port's dense decoder against the JAX package, on the same weights.

JAX params come from ``repro.models.model.init_params`` and reach the port
through ``jax.device_get`` and ``repro_torch.convert.params_from_jax``. In
the f32 smoke config (3 groups, H=4, KV=2, hd=16) the port's ``prefill`` and
``decode_step`` logits match JAX's to atol 1e-4 at every depth, with mixed
per-slot widths, unfused and fused, and the caches they leave behind match
too. On the CPU the kernels run their plain versions.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.core import elastic as jax_elastic
from repro.models import model as JM
from repro_torch.configs import smoke_config
from repro_torch.convert import cache_from_jax, params_from_jax, to_numpy
from repro_torch.core import elastic
from repro_torch.models import model as TM
from torch_threads import one_thread  # noqa: E402,F401  (autouse)

ATOL = 1e-4
VARIANTS = {"full": {}, "kv_quant": {"kv_quant": True},
            "swa": {"sliding_window": 5}}


def _cfgs(variant):
    kw = VARIANTS[variant]
    return (dataclasses.replace(jax_smoke_config("tinyllama-1.1b"), **kw),
            dataclasses.replace(smoke_config("tinyllama-1.1b"), **kw))


@pytest.fixture(scope="module")
def jax_params():
    jcfg, _ = _cfgs("full")
    return jax.device_get(JM.init_params(jax.random.PRNGKey(0), jcfg))


def _assert_cache_close(tc, jc, msg):
    got, want = to_numpy(tc), jax.device_get(jc)
    np.testing.assert_array_equal(got["pos"], np.asarray(want["pos"]))
    for pn, layer in want["stack"].items():
        for k, a in layer.items():
            np.testing.assert_allclose(
                got["stack"][pn][k], np.asarray(a, np.float32), atol=ATOL,
                rtol=1e-4, err_msg=f"{msg} cache {pn}/{k}")


_JAX_DECODE = {}


def _jax_decode_ref(jax_params, variant):
    """JAX decode over 7 steps (past the sliding window, so the buffer
    rolls) at every depth with mixed widths; computed once per variant and
    shared by the unfused and fused port tests."""
    if variant not in _JAX_DECODE:
        jcfg, _ = _cfgs(variant)
        ja = jax_elastic.active_widths_batch(jcfg, [0.5, 1.0])
        step = jax.jit(JM.decode_step, static_argnames=("cfg", "depth"))
        rng = np.random.default_rng(1)
        runs = []
        for depth in sorted({m.depth for m in jcfg.elastic.modes(jcfg.n_groups)}):
            cache = JM.init_decode_cache(jcfg, 2, 16, per_slot=True)
            cache0 = jax.device_get(cache)
            toks, logits = [], []
            for _ in range(7):
                tok = rng.integers(1, jcfg.vocab_size, (2, 1)).astype(np.int32)
                lg, cache = step(jax_params, cache, jnp.asarray(tok), cfg=jcfg,
                                 depth=depth, active=ja)
                toks.append(tok)
                logits.append(np.asarray(lg))
            runs.append((depth, cache0, toks, logits, jax.device_get(cache)))
        _JAX_DECODE[variant] = runs
    return _JAX_DECODE[variant]


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_decode_step_matches_jax(jax_params, variant, fused):
    _, tcfg = _cfgs(variant)
    tp = params_from_jax(jax_params, device="cpu")
    ta = elastic.active_widths_batch(tcfg, [0.5, 1.0], device="cpu")
    for depth, cache0, toks, jlogits, jcache in _jax_decode_ref(jax_params,
                                                               variant):
        tc = cache_from_jax(cache0, device="cpu")
        for t, (tok, jl) in enumerate(zip(toks, jlogits)):
            tl, tc = TM.decode_step(tp, tc, torch.from_numpy(tok).long(),
                                    tcfg, depth=depth, active=ta, fused=fused)
            np.testing.assert_allclose(tl.numpy(), jl, atol=ATOL, rtol=0,
                                       err_msg=f"depth {depth} t {t}")
        _assert_cache_close(tc, jcache, f"depth {depth}")


@pytest.mark.parametrize("variant", ["full", "swa"])
def test_prefill_slot_then_decode_matches_jax(jax_params, variant):
    jcfg, tcfg = _cfgs(variant)
    tp = params_from_jax(jax_params, device="cpu")
    prompt = np.array([[7, 3, 9, 11, 2, 5, 8]], np.int32)
    for depth in (1, jcfg.n_groups):
        jl, jc = JM.prefill(jax_params, {"tokens": jnp.asarray(prompt)}, jcfg,
                            cache_extra=5, per_slot=True, slot=1, n_slots=2,
                            depth=depth)
        tl, tc = TM.prefill(tp, {"tokens": torch.from_numpy(prompt).long()},
                            tcfg, cache_extra=5, per_slot=True, slot=1,
                            n_slots=2, depth=depth)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   rtol=0)
        _assert_cache_close(tc, jc, f"prefill depth {depth}")
        # adopt into a live engine cache and keep decoding
        je = JM.init_decode_cache(jcfg, 2, prompt.shape[1] + 5, per_slot=True)
        te = cache_from_jax(jax.device_get(je), device="cpu")
        je = JM.adopt_cache_slot(je, jc, 1)
        te = TM.adopt_cache_slot(te, tc, 1)
        tok = np.array([[4], [6]], np.int32)
        jl, je = JM.decode_step(jax_params, je, jnp.asarray(tok), jcfg,
                                depth=depth)
        tl, te = TM.decode_step(tp, te, torch.from_numpy(tok).long(), tcfg,
                                depth=depth)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   rtol=0)
        _assert_cache_close(te, je, f"adopted depth {depth}")


def test_reset_cache_slots_rewinds_in_place():
    _, tcfg = _cfgs("full")
    cache = TM.init_decode_cache(tcfg, 3, 8, per_slot=True, device="cpu")
    cache["pos"][:] = torch.tensor([4, 5, 6], dtype=torch.int32)
    out = TM.reset_cache_slots(cache, np.array([True, False, True]))
    assert out is cache
    assert cache["pos"].tolist() == [0, 5, 0]
    TM.reset_cache_slot(cache, 1)
    assert cache["pos"].tolist() == [0, 0, 0]


def test_init_params_matches_jax_layout_and_scale():
    jcfg, tcfg = _cfgs("full")
    jp = jax.device_get(JM.init_params(jax.random.PRNGKey(0), jcfg))
    tp = TM.init_params(tcfg, seed=0, device="cpu")

    def walk(a, b, path=""):
        assert set(a) == set(b), path
        for k in a:
            if isinstance(a[k], dict):
                walk(a[k], b[k], f"{path}/{k}")
            else:
                assert tuple(b[k].shape) == np.shape(a[k]), f"{path}/{k}"
                assert str(b[k].dtype).endswith(str(np.asarray(a[k]).dtype))
                sa, sb = float(np.std(a[k])), float(b[k].float().std())
                assert abs(sa - sb) <= 0.1 * max(sa, 1e-6) + 1e-6, f"{path}/{k}"

    walk(jp, tp)
    # SSM layers arrived with the SSM slice (tests/test_torch_ssm.py)
    assert "ssm" in TM.init_params(smoke_config("mamba2-370m"),
                                   device="cpu")["stack"]["pos0"]
    # MoE layers arrived with the MoE slice (tests/test_torch_moe.py)
    layer = TM.init_params(smoke_config("mixtral-8x22b"),
                           device="cpu")["stack"]["pos0"]
    assert {"moe", "norm2"} <= set(layer) and "mlp" not in layer


def test_norm_masked_and_chunked_attention_match_jax():
    """The layer helpers the decode test does not reach: the masked RMSNorm
    and the blockwise attention prefill switches to past 2048 keys."""
    from repro.models import layers as JL
    from repro_torch.models import layers as TL

    jcfg, tcfg = _cfgs("full")
    jcfg = dataclasses.replace(jcfg, attn_chunk=5)
    tcfg = dataclasses.replace(tcfg, attn_chunk=5)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 3, jcfg.d_model)).astype(np.float32)
    x[0, :, 40:] = 0.0
    scale = rng.standard_normal(jcfg.d_model).astype(np.float32)
    n = np.array([40, 64], np.int32)
    want = JL.apply_norm_masked({"scale": jnp.asarray(scale)}, jnp.asarray(x),
                                jcfg, jnp.asarray(n)[:, None])
    got = TL.apply_norm_masked({"scale": torch.from_numpy(scale)},
                               torch.from_numpy(x), tcfg,
                               torch.from_numpy(n)[:, None])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    B, S, H, KV, hd = 2, 12, jcfg.n_heads, jcfg.n_kv_heads, jcfg.head_dim
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)
    for window in (0, 4):
        jc = dataclasses.replace(jcfg, sliding_window=window)
        tc = dataclasses.replace(tcfg, sliding_window=window)
        want = JL.attention_chunked(*(jnp.asarray(a) for a in (q, k, v)), jc,
                                    jnp.asarray(pos), jnp.asarray(pos))
        got = TL.attention_chunked(*(torch.from_numpy(a) for a in (q, k, v)),
                                   tc, torch.from_numpy(pos),
                                   torch.from_numpy(pos))
        full = TL.attention_full(*(torch.from_numpy(a) for a in (q, k, v)),
                                 tc, torch.from_numpy(pos),
                                 torch.from_numpy(pos))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=1e-5)
        np.testing.assert_allclose(got.numpy(), full.numpy(), atol=1e-5,
                                   rtol=1e-5)
