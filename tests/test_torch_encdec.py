"""The port's encoder-decoder and vision-frontend models against JAX.

Same weights in both packages (JAX init, converted through numpy with
``params_from_jax``), batches from the port's ``make_batch`` (``frames``
for whisper, ``patches`` for internvl), the f32 smoke configs of
``whisper-base`` (3 decoder groups, 2 encoder layers, enc_seq 24, H = 4 /
KV = 2 of 16, sinusoidal positions) and ``internvl2-2b`` (3 groups, RoPE,
8 prepended patches). Tolerances, all in f32:

* logits of ``forward`` (with the exit heads), ``prefill`` and chained
  ``decode_step`` (every depth, mixed per-slot widths, unfused and fused),
  the cross-attention decode and the caches: atol 1e-4, as
  ``tests/test_torch_model.py``; the port's ``cross_k`` / ``cross_v``
  (G, B, KV, enc_seq, hd) are swapped back to JAX's layout to compare;
* losses: rtol 1e-5; gradients: |port - JAX| <= 1e-4 max |g| of each leaf,
  as ``tests/test_torch_train.py``;
* ``sinusoidal_pos``: atol 2e-4 at positions below 1500. XLA's and
  PyTorch's f32 ``exp`` give frequencies up to one ulp apart (<= 2^-23 for
  a frequency <= 1), and the angle multiplies that by the position: 1500
  x 1.2e-7 = 1.8e-4 rad at most; the sines of one f32 angle agree;
* ``slice_params``: the same views, bit for bit.

On the CPU every kernel route runs its plain version: the cross decode the
einsum, the ``attn_impl="chunked"`` prompt pass ``attention_chunked``, and
``ops.flash_attention_bshd`` (the card's route for unmasked passes with
Sq != Sk) ``flash_attention_plain``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.core import elastic as JE
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch.configs import smoke_config
from repro_torch.convert import cache_from_jax, params_from_jax, to_numpy
from repro_torch.core import elastic as TE
from repro_torch.data import pipeline as TD
from repro_torch.kernels import ops
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.optim import optimizer as TO
from torch_threads import one_thread  # noqa: E402,F401  (autouse)

ATOL = 1e-4
ATOL_SIN = 2e-4
GRAD_RTOL = 1e-4
ARCHS = ("whisper-base", "internvl2-2b")
WIDTHS = [0.5, 1.0]


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _leaves(v, p)
        else:
            yield p, v


def _batch(arch, **kw):
    dc = TD.DataConfig(**{"seed": 3, "global_batch": 2, "seq_len": 16, **kw})
    return TD.make_batch(smoke_config(arch), dc, 0)


def _jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


@pytest.fixture(scope="module")
def jax_params():
    init = jax.jit(JM.init_params, static_argnums=1)
    return {arch: jax.device_get(init(jax.random.PRNGKey(0),
                                      jax_smoke_config(arch)))
            for arch in ARCHS}


@pytest.fixture(scope="module")
def jax_prefill(jax_params):
    """JAX prefill of each arch (per-slot cache, 6 free positions)."""
    out = {}
    for arch in ARCHS:
        lg, cache = JM.prefill(jax_params[arch], _jbatch(_batch(arch)),
                               jax_smoke_config(arch), cache_extra=6,
                               per_slot=True)
        out[arch] = (np.asarray(lg), jax.device_get(cache))
    return out


@pytest.fixture(scope="module")
def jax_decode(jax_params, jax_prefill):
    """JAX decode chained from the prefill for 3 steps at every depth, the
    2 slots at widths 0.5 and 1.0 (unfused; the port's fused path is held
    to the same logits)."""
    out = {}
    step = jax.jit(JM.decode_step, static_argnames=("cfg", "depth"))
    for arch in ARCHS:
        jcfg = jax_smoke_config(arch)
        ja = JE.active_widths_batch(jcfg, WIDTHS)
        runs = []
        for depth in sorted({m.depth for m in jcfg.elastic.modes(jcfg.n_groups)}):
            cache = jax_prefill[arch][1]
            rng = np.random.default_rng(depth)
            toks, logits = [], []
            for _ in range(3):
                tok = rng.integers(1, jcfg.vocab_size, (2, 1)).astype(np.int32)
                lg, cache = step(jax_params[arch], cache, jnp.asarray(tok),
                                 cfg=jcfg, depth=depth, active=ja)
                toks.append(tok)
                logits.append(np.asarray(lg))
            runs.append((depth, toks, logits, jax.device_get(cache)))
        out[arch] = runs
    return out


def _assert_cache_close(tc, jc, msg):
    """Every leaf of the port's cache ``tc`` against JAX's ``jc``, the
    cross leaves swapped back to JAX's (B, enc_seq, KV, hd) order."""
    got = to_numpy(tc)
    np.testing.assert_array_equal(got["pos"], np.asarray(jc["pos"]))
    for pn, layer in jc["stack"].items():
        assert set(got["stack"][pn]) == set(layer), msg
        for k, a in layer.items():
            g = got["stack"][pn][k]
            if k.startswith("cross_"):
                g = np.swapaxes(g, -3, -2)
            np.testing.assert_allclose(g, np.asarray(a, np.float32),
                                       atol=ATOL, rtol=0,
                                       err_msg=f"{msg} cache {pn}/{k}")


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d", [64, 2])
def test_sinusoidal_pos_matches_jax(d):
    pos = np.random.default_rng(0).integers(0, 1500, (3, 7)).astype(np.int32)
    want = np.asarray(JL.sinusoidal_pos(jnp.asarray(pos), d))
    got = TL.sinusoidal_pos(torch.from_numpy(pos), d)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL_SIN, rtol=0)


def test_cross_mha_decode_matches_jax(jax_params):
    """One decoder layer's cross attention over random encoder K/V: the
    query gated at each slot's width, wo at the same width; inactive heads
    attend to non-zero values and only wo's contraction gate drops them.
    The port's cache is (B, KV, enc_seq, hd), JAX's (B, enc_seq, KV, hd);
    a scalar position and per-slot ones give the same result."""
    arch = "whisper-base"
    jcfg, cfg = jax_smoke_config(arch), smoke_config(arch)
    lp = jax.tree_util.tree_map(lambda a: a[1],
                                jax_params[arch]["stack"]["pos0"]["cross"])
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    kv = rng.standard_normal((2, 2, cfg.enc_seq, cfg.n_kv_heads,
                              cfg.head_dim)).astype(np.float32)
    pos = np.array([3, 11], np.int32)
    want, _ = JL.mha_decode(lp, jnp.asarray(x), {"k": kv[0], "v": kv[1]},
                            jnp.asarray(pos), jcfg, cross=True,
                            active=JE.active_widths_batch(jcfg, WIDTHS))
    ta = TE.active_widths_batch(cfg, WIDTHS, device="cpu")
    cache = {"k": torch.from_numpy(kv[0]).transpose(1, 2).contiguous(),
             "v": torch.from_numpy(kv[1]).transpose(1, 2).contiguous()}
    tp = params_from_jax(lp, device="cpu")
    for p in (torch.from_numpy(pos), torch.tensor(5, dtype=torch.int32)):
        got, c = TL.mha_decode(tp, torch.from_numpy(x), cache, p, cfg,
                               cross=True, active=ta, fused=True)
        assert c is cache
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=0)


@pytest.mark.parametrize("sq,sk", [(5, 24), (40, 40)])
def test_flash_route_unmasked_matches_einsum(sq, sk):
    """The route an unmasked prompt-pass attention takes on a card (the
    encoder's self-attention, the decoder's cross-attention: Sq != Sk,
    ragged tiles) computes ``attention_full``'s function; on the CPU the
    route is the kernel's plain version."""
    cfg = smoke_config("whisper-base")
    rng = np.random.default_rng(sq)
    q = torch.from_numpy(rng.standard_normal((2, sq, 4, 16)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((2, sk, 2, 16)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((2, sk, 2, 16)).astype(np.float32))
    got = ops.flash_attention_bshd(q, k, v, causal=False, bq=16, bk=16)
    want = TL.attention_full(q, k, v, cfg, torch.arange(sq),
                             torch.arange(sk), causal=False)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL, rtol=0)


# ---------------------------------------------------------------------------
# parameters, full-sequence path, training
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_has_the_reference_tree(jax_params, arch):
    got = {p: tuple(a.shape) for p, a in
           _leaves(TM.init_params(smoke_config(arch), seed=0, device="cpu"))}
    want = {p: tuple(np.shape(a)) for p, a in _leaves(jax_params[arch])}
    assert got == want


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(jax_params, arch):
    jcfg, cfg = jax_smoke_config(arch), smoke_config(arch)
    b = _batch(arch)
    want, _ = JM.forward(jax_params[arch], _jbatch(b), jcfg, collect_exits=(1,))
    got, _ = TM.forward(params_from_jax(jax_params[arch], device="cpu"),
                        TD.to_device(b, "cpu"), cfg, collect_exits=(1,))
    assert set(got) == set(want) == {"final", "exit_g1"}
    for k in want:
        np.testing.assert_allclose(to_numpy(got[k]), np.asarray(want[k]),
                                   atol=ATOL, rtol=0, err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(jax_params, arch):
    """``loss_fn`` with a loss mask (internvl: over the text only, its
    patches' logits dropped) and its gradients, the encoder's and the
    frontend projection's included."""
    jcfg, cfg = jax_smoke_config(arch), smoke_config(arch)
    b = _batch(arch)
    b["loss_mask"] = (np.random.default_rng(5).random(b["targets"].shape)
                      < 0.7).astype(np.float32)
    fn = jax.jit(jax.value_and_grad(
        lambda p, jb: JM.loss_fn(p, jb, jcfg)[0]))
    want_loss, want_g = fn(jax_params[arch], _jbatch(b))
    tp = TO.trainable(params_from_jax(jax_params[arch], device="cpu"))
    loss, _ = TM.loss_fn(tp, TD.to_device(b, "cpu"), cfg)
    assert loss.item() == pytest.approx(float(want_loss), rel=1e-5)
    want_g = dict(_leaves(jax.device_get(want_g)))
    got_g = dict(_leaves(to_numpy(TO.grads_of(loss, tp))))
    assert set(got_g) == set(want_g)
    for path, g in got_g.items():
        w = np.asarray(want_g[path], np.float32)
        tol = GRAD_RTOL * max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g, w, atol=tol, rtol=0, err_msg=path)


def test_slice_params_and_morph_forward_match_jax(jax_params):
    """Width slicing reaches the cross-attention and the encoder's layers,
    as prefix views of the same numbers; the sliced subnet's logits match
    JAX's."""
    arch = "whisper-base"
    jcfg, cfg = jax_smoke_config(arch), smoke_config(arch)
    mode = [m for m in cfg.elastic.modes(cfg.n_groups) if m.width < 1.0][-1]
    jmode = [m for m in jcfg.elastic.modes(jcfg.n_groups)
             if m.name == mode.name][0]
    tp = params_from_jax(jax_params[arch], device="cpu")
    got = dict(_leaves(TE.slice_params(tp, cfg, mode)))
    want = dict(_leaves(jax.device_get(
        JE.slice_params(jax_params[arch], jcfg, jmode))))
    assert set(got) == set(want)
    sliced = [p for p in want if np.shape(want[p]) != np.shape(
        dict(_leaves(jax_params[arch]))[p])]
    assert any("cross" in p for p in sliced)
    assert any(p.startswith("encoder/") for p in sliced)
    for p, a in want.items():
        np.testing.assert_array_equal(got[p].numpy(), np.asarray(a), err_msg=p)
    b = _batch(arch)
    wl, _ = JE.morph_forward(jax_params[arch], _jbatch(b), jcfg, jmode)
    gl, _ = TE.morph_forward(tp, TD.to_device(b, "cpu"), cfg, mode)
    np.testing.assert_allclose(to_numpy(gl["final"]), np.asarray(wl["final"]),
                               atol=ATOL, rtol=0)


# ---------------------------------------------------------------------------
# prompt pass and decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_caches_match_jax(jax_params, jax_prefill, arch):
    """Last-position logits and every cache leaf (whisper: the cross K/V in
    every decoder layer); the port's ``cache_from_jax`` takes JAX's cache
    to the port's layout; a batch-1 prompt scattered into one slot keeps
    the cross leaves in that slot's lane."""
    cfg = smoke_config(arch)
    want_lg, want_c = jax_prefill[arch]
    tp = params_from_jax(jax_params[arch], device="cpu")
    b = _batch(arch)
    lg, cache = TM.prefill(tp, TD.to_device(b, "cpu"), cfg, cache_extra=6,
                           per_slot=True)
    np.testing.assert_allclose(to_numpy(lg), want_lg, atol=ATOL, rtol=0)
    _assert_cache_close(cache, want_c, arch)
    conv = cache_from_jax(want_c, device="cpu")
    for pn, layer in cache["stack"].items():
        for k, a in layer.items():
            assert conv["stack"][pn][k].shape == a.shape
            assert conv["stack"][pn][k].is_contiguous()
    if cfg.is_encdec:
        assert "cross_k" in cache["stack"]["pos0"]
    one = TD.to_device({k: v[1:] for k, v in b.items()}, "cpu")
    _, sc = TM.prefill(tp, one, cfg, cache_extra=6, per_slot=True, slot=2,
                       n_slots=3)
    for pn, layer in sc["stack"].items():
        for k, a in layer.items():
            np.testing.assert_allclose(a[:, 2].numpy(),
                                       cache["stack"][pn][k][:, 1].numpy(),
                                       atol=ATOL, rtol=0, err_msg=k)
            assert not a[:, [0, 1]].any()


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_chain_matches_jax(jax_params, jax_prefill, jax_decode, arch,
                                  fused):
    cfg = smoke_config(arch)
    tp = params_from_jax(jax_params[arch], device="cpu")
    ta = TE.active_widths_batch(cfg, WIDTHS, device="cpu")
    for depth, toks, logits, final in jax_decode[arch]:
        cache = cache_from_jax(jax_prefill[arch][1], device="cpu")
        for tok, want in zip(toks, logits):
            lg, cache = TM.decode_step(tp, cache, torch.from_numpy(tok).long(),
                                       cfg, depth=depth, active=ta,
                                       fused=fused)
            np.testing.assert_allclose(to_numpy(lg), want, atol=ATOL, rtol=0,
                                       err_msg=f"depth {depth}")
        _assert_cache_close(cache, final, f"depth {depth}")


@pytest.mark.parametrize("arch", ARCHS)
def test_chunked_prompt_pass_matches_jax(jax_params, arch):
    """``attn_impl="chunked"`` (the card's flash-kernel route; on the CPU
    ``attention_chunked`` at chunks of 8, so the 24 encoder keys span three
    chunks) against JAX's chunked prompt pass."""
    jcfg = dataclasses.replace(jax_smoke_config(arch), attn_impl="chunked",
                               attn_chunk=8)
    cfg = dataclasses.replace(smoke_config(arch), attn_impl="chunked",
                              attn_chunk=8)
    b = _batch(arch)
    want, _ = JM.prefill(jax_params[arch], _jbatch(b), jcfg)
    got, _ = TM.prefill(params_from_jax(jax_params[arch], device="cpu"),
                        TD.to_device(b, "cpu"), cfg)
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), atol=ATOL,
                               rtol=0)


def test_sinusoidal_decoder_verify_matches_jax():
    """A decoder-only model without RoPE takes sinusoidal positions on
    every path: the prompt pass, decode, and the speculative verify at each
    slot's positions (TinyLlama's smoke config with ``use_rope=False``)."""
    jcfg = dataclasses.replace(jax_smoke_config("tinyllama-1.1b"),
                               use_rope=False)
    cfg = dataclasses.replace(smoke_config("tinyllama-1.1b"), use_rope=False)
    jp = jax.device_get(jax.jit(JM.init_params, static_argnums=1)(
        jax.random.PRNGKey(2), jcfg))
    toks = np.random.default_rng(6).integers(1, 500, (2, 7)).astype(np.int32)
    _, jc = JM.prefill(jp, {"tokens": jnp.asarray(toks[:, :4])}, jcfg,
                       cache_extra=8, per_slot=True)
    want, _ = JM.verify_step(jp, jc, jnp.asarray(toks[:, 4:]), jcfg)
    tp = params_from_jax(jp, device="cpu")
    _, tc = TM.prefill(tp, {"tokens": torch.from_numpy(toks[:, :4]).long()},
                       cfg, cache_extra=8, per_slot=True)
    got, _ = TM.verify_step(tp, tc, torch.from_numpy(toks[:, 4:]).long(), cfg)
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), atol=ATOL,
                               rtol=0)
