"""The port's block-paged KV cache against the JAX package, and its paged
engines against its dense ones.

Same inputs in both packages (numpy seeds; JAX weights converted through
numpy), f32 smoke config (3 groups, H = 4, KV = 2, hd = 16), page size 4:

* ``PagedLayout``'s arithmetic and its validation errors equal JAX's over a
  grid of (capacity, window, page size, pool size);
* a seeded sequence of ``BlockAllocator`` / ``RadixCache`` operations gives
  the same returns, refcounts, free counts and evictions in both packages;
* ``mha_decode`` / ``mha_verify`` through a shuffled page table equal JAX's
  paged versions (outputs, the pool leaves after the write, candidates):
  full attention, a sliding window of 8 and int8 KV, atol 1e-5;
* ``fused_decode_plain`` / ``fused_verify_plain`` over a shuffled table
  with one page shared by two slots equal the Pallas kernels in interpret
  mode (``impl="pallas", interpret=True, pages=...``) at the tolerances of
  their dense cases (``test_torch_kernels.py``: decode atol 2e-5 rtol 1e-4,
  verify atol = rtol = 1e-5), int8 values exactly;
* ``decode_step`` / ``verify_step`` / ``commit_verify`` over a paged cache
  equal JAX's (logits, pools and positions, atol 1e-4);
* in the port alone: paged engines emit the dense engines' tokens (plain
  unfused and fused: full, window, int8 KV; greedy speculative unfused and
  fused) on a trace with mixed widths, a depth switch, both admission paths
  and two prompts sharing a 2-page prefix; a shared prefix maps the same
  physical pages with exact refcounts; slots growing through several
  table-width buckets build nothing after warmup; an undersized pool is a
  hard error; ``check_paged_invariants`` holds after every engine tick.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.kernels import fused_decode as JFD
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import paged as JP
from repro.runtime import paged_cache as JPC
from repro_torch.configs import smoke_config
from repro_torch.convert import cache_from_jax, params_from_jax, to_numpy
from repro_torch.kernels import fused_decode as FD
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import paged as TP
from repro_torch.runtime import paged_cache as TPC
from repro_torch.runtime import serving as TS
from repro_torch.runtime.speculative import SpecConfig
from torch_threads import one_thread  # noqa: E402,F401  (autouse)

PS = 4
VARIANTS = {"full": {}, "swa": {"sliding_window": 8},
            "kv_quant": {"kv_quant": True}}


def _cfgs(variant):
    kw = VARIANTS[variant]
    return (dataclasses.replace(jax_smoke_config("tinyllama-1.1b"), **kw),
            dataclasses.replace(smoke_config("tinyllama-1.1b"), **kw))


# ---------------------------------------------------------------------------
# layout and host bookkeeping
# ---------------------------------------------------------------------------


def _layout_outcome(layout, cfg, cap):
    try:
        layout.validate(cfg, cap)
    except ValueError as e:
        return ("error", str(e))
    cp = layout.cap_pages(cfg, cap)
    return ("ok", layout.seq_capacity(cfg, cap), cp,
            layout.pool_pages(cfg, 3, cap), layout.buckets(cfg, cap),
            [layout.bucket_for(cfg, cap, n) for n in range(1, cp + 2)])


def test_paged_layout_matches_jax():
    seen = set()
    for window in (0, 4, 8):
        jcfg = dataclasses.replace(jax_smoke_config("tinyllama-1.1b"),
                                   sliding_window=window)
        tcfg = dataclasses.replace(smoke_config("tinyllama-1.1b"),
                                   sliding_window=window)
        for cap in (8, 12, 30, 32):
            for ps in (0, 1, 2, 3, 4, 5, 8):
                for n in (None, 0, 7):
                    want = _layout_outcome(JP.PagedLayout(ps, n), jcfg, cap)
                    got = _layout_outcome(TP.PagedLayout(ps, n), tcfg, cap)
                    assert got == want, (window, cap, ps, n)
                    seen.add(want[0] if want[0] == "ok" else want[1][:20])
    assert "ok" in seen and len(seen) >= 4  # every error kind was reached
    for name in ("k", "v", "k_scale", "v_scale", "state", "conv_x"):
        assert TP.is_paged_key(name) == JP.is_paged_key(name)


def test_allocator_and_radix_match_jax():
    """One seeded stream of allocator and radix operations, applied to both
    packages: equal returns (or equal errors) after every operation, and
    equal refcounts, free counts, held pages and statistics."""
    rng = np.random.default_rng(0)
    objs = []
    for mod in (JPC, TPC):
        alloc = mod.BlockAllocator(12)
        objs.append((alloc, mod.RadixCache(alloc)))
    vocab, ps = 3, 2  # a small alphabet, so prefixes collide
    for step in range(600):
        op = rng.integers(0, 6)
        key = int(rng.integers(0, 2))
        n = int(rng.integers(1, 4))
        chunks = [tuple(int(t) for t in rng.integers(0, vocab, ps))
                  for _ in range(n)]
        pid = int(rng.integers(0, 12))
        ev = int(rng.integers(1, 3))
        outs = []
        for alloc, radix in objs:
            try:
                if op == 0:
                    r = alloc.alloc()
                elif op == 1:
                    r = alloc.incref(pid)
                elif op == 2:
                    r = alloc.decref(pid)
                elif op == 3:
                    r = radix.match(key, chunks)
                elif op == 4:
                    # insert pages the caller holds (fresh ones when it can)
                    pages = [alloc.alloc() if alloc.can_alloc() else pid
                             for _ in chunks]
                    r = (pages, radix.insert(key, chunks, pages))
                else:
                    r = radix.evict_lru(ev)
            except RuntimeError as e:
                r = ("error", str(e))
            outs.append((r, list(alloc.refcount), alloc.n_free,
                         sorted(radix.held_pages()), radix.stats(),
                         alloc.metric_values()))
        assert outs[0] == outs[1], f"step {step}, op {op}"


# ---------------------------------------------------------------------------
# layers and plain kernels through a page table
# ---------------------------------------------------------------------------


def _attn_operands(variant, seed, S=1, shared=True):
    """One attention layer's weights, a pool with a shuffled table (slots 0
    and 1 sharing their first page unless ``shared`` is False), per-slot
    positions whose writes land in private pages, mixed widths."""
    jcfg, tcfg = _cfgs(variant)
    rng = np.random.default_rng(seed)
    dm, H, KV, hd = jcfg.d_model, jcfg.n_heads, jcfg.n_kv_heads, jcfg.head_dim
    s = 1.0 / np.sqrt(dm)
    params = {"wq": rng.standard_normal((dm, H * hd)) * s,
              "wk": rng.standard_normal((dm, KV * hd)) * s,
              "wv": rng.standard_normal((dm, KV * hd)) * s,
              "wo": rng.standard_normal((H * hd, dm)) / np.sqrt(H * hd)}
    params = {k: v.astype(np.float32) for k, v in params.items()}
    B, n_pages = 3, 14
    P = (jcfg.sliding_window or 16) // PS
    table = rng.permutation(n_pages)[:B * P].reshape(B, P).astype(np.int32)
    if shared and not jcfg.sliding_window:
        table[1, 0] = table[0, 0]
    shape = (n_pages, PS, KV, hd)
    if jcfg.kv_quant:
        pool = {"k": rng.integers(-127, 128, shape).astype(np.int8),
                "v": rng.integers(-127, 128, shape).astype(np.int8),
                "k_scale": rng.uniform(0.001, 0.02, shape[:-1] + (1,)),
                "v_scale": rng.uniform(0.001, 0.02, shape[:-1] + (1,))}
    else:
        pool = {"k": rng.standard_normal(shape).astype(np.float32),
                "v": rng.standard_normal(shape).astype(np.float32)}
    x = rng.standard_normal((B, S, dm)).astype(np.float32)
    # writes at positions >= 4 (past the shared first page); the window
    # wraps (position 13 of an 8-position window)
    pos = np.array([5, 9, 13] if S == 1 else [4, 7, 9], np.int32)
    a_q = np.array([32, 64, 24], np.int32)
    a_kv = np.array([16, 32, 24], np.int32)
    return jcfg, tcfg, params, x, pool, table, pos, a_q, a_kv


def _jax_pool(pool):
    return {k: jnp.asarray(v, jnp.bfloat16) if k.endswith("scale")
            else jnp.asarray(v) for k, v in pool.items()}


def _torch_pool(pool):
    return {k: torch.from_numpy(np.asarray(v, np.float32)).to(torch.bfloat16)
            if k.endswith("scale") else torch.from_numpy(np.array(v))
            for k, v in pool.items()}


def _assert_pool(got, want, tol, msg):
    for k in want:
        g, w = got[k].float().numpy(), np.asarray(want[k], np.float32)
        if got[k].dtype == torch.int8:
            np.testing.assert_array_equal(g, w, err_msg=f"{msg} {k}")
        else:
            np.testing.assert_allclose(g, w, **tol, err_msg=f"{msg} {k}")


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_mha_paged_matches_jax(variant):
    """``mha_decode`` (output and the pool after its write) and
    ``mha_verify`` (output and candidates, S = 3) through a shuffled table,
    atol = rtol = 1e-5."""
    tol = dict(atol=1e-5, rtol=1e-5)
    for S in (1, 3):
        jcfg, tcfg, params, x, pool, table, pos, a_q, a_kv = _attn_operands(
            variant, 11, S=S)
        jact = {"q_dim": jnp.asarray(a_q), "kv_dim": jnp.asarray(a_kv)}
        tact = {"q_dim": torch.from_numpy(a_q),
                "kv_dim": torch.from_numpy(a_kv)}
        jp = {k: jnp.asarray(v) for k, v in params.items()}
        tp = {k: torch.from_numpy(v) for k, v in params.items()}
        tpool = _torch_pool(pool)
        fn_j, fn_t = ((JL.mha_decode, TL.mha_decode) if S == 1
                      else (JL.mha_verify, TL.mha_verify))
        o_j, c_j = fn_j(jp, jnp.asarray(x), _jax_pool(pool), jnp.asarray(pos),
                        jcfg, active=jact, pages=jnp.asarray(table),
                        page_size=PS)
        o_t, c_t = fn_t(tp, torch.from_numpy(x), tpool, torch.from_numpy(pos),
                        tcfg, active=tact, pages=torch.from_numpy(table),
                        page_size=PS)
        np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), **tol,
                                   err_msg=f"{variant} S={S} out")
        # decode: the pools after the write; verify: the candidates
        _assert_pool(c_t, c_j, tol, f"{variant} S={S}")


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_fused_plain_paged_matches_pallas(variant):
    """The plain paged versions against the Pallas kernels in interpret
    mode, on a shuffled table whose first page two slots share: decode
    (output, pool; atol 2e-5 rtol 1e-4, int8 exactly) and linear verify
    (S = 3: output and candidates; atol = rtol = 1e-5)."""
    for S, tol in ((1, dict(atol=2e-5, rtol=1e-4)),
                   (3, dict(atol=1e-5, rtol=1e-5))):
        jcfg, tcfg, params, x, pool, table, pos, a_q, a_kv = _attn_operands(
            variant, 21, S=S)
        jact = {"q_dim": jnp.asarray(a_q), "kv_dim": jnp.asarray(a_kv)}
        tact = {"q_dim": torch.from_numpy(a_q),
                "kv_dim": torch.from_numpy(a_kv)}
        jp = {k: jnp.asarray(v) for k, v in params.items()}
        tp = {k: torch.from_numpy(v) for k, v in params.items()}
        tpool = _torch_pool(pool)
        kw = dict(pages=jnp.asarray(table), page_size=PS, impl="pallas",
                  interpret=True)
        if S == 1:
            o_j, c_j = JFD.fused_decode_step(jp, jnp.asarray(x),
                                             _jax_pool(pool), jnp.asarray(pos),
                                             jcfg, active=jact, **kw)
            o_t, c_t = FD.fused_decode_step(
                tp, torch.from_numpy(x), tpool, torch.from_numpy(pos), tcfg,
                active=tact, pages=torch.from_numpy(table), page_size=PS)
        else:
            o_j, c_j = jax.jit(lambda p, x_, c, pos_, act: JFD.fused_verify(
                p, x_, c, pos_, jcfg, active=act, **kw))(
                jp, jnp.asarray(x), _jax_pool(pool), jnp.asarray(pos), jact)
            o_t, c_t = FD.fused_verify(
                tp, torch.from_numpy(x), tpool, torch.from_numpy(pos), tcfg,
                active=tact, pages=torch.from_numpy(table), page_size=PS)
        np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), **tol,
                                   err_msg=f"{variant} S={S} out")
        _assert_pool(c_t, c_j, tol, f"{variant} S={S}")
    assert FD.launch_count() == FD.verify_launch_count() == 0


@pytest.mark.parametrize("variant", ["full", "kv_quant"])
def test_model_paged_decode_verify_commit_match_jax(variant):
    """Three ``decode_step`` calls at staggered positions, then
    ``verify_step`` over S = 3 and ``commit_verify`` with acceptance counts
    (0, 2, 1), all through a shuffled table, against JAX: logits, the
    pools and the positions, atol 1e-4."""
    jcfg, tcfg = _cfgs(variant)
    jp = jax.device_get(JM.init_params(jax.random.PRNGKey(0), jcfg))
    tp = params_from_jax(jp, device="cpu")
    B, cap = 3, 16
    layout = JP.PagedLayout(page_size=PS)
    rng = np.random.default_rng(5)
    table = rng.permutation(layout.pool_pages(jcfg, B, cap))[
        :B * (cap // PS)].reshape(B, cap // PS).astype(np.int32)
    jc = JP.init_paged_cache(jcfg, B, cap, layout)
    jc["pos"] = jnp.asarray([0, 2, 5], jnp.int32)
    tc = cache_from_jax(jax.device_get(jc), device="cpu")
    jt, tt = jnp.asarray(table), torch.from_numpy(table)
    tol = dict(atol=1e-4, rtol=1e-4)
    dstep = jax.jit(JM.decode_step, static_argnames=("cfg", "page_size"))
    for i in range(3):
        tok = rng.integers(1, jcfg.vocab_size, (B, 1))
        lj, jc = dstep(jp, jc, jnp.asarray(tok, jnp.int32), cfg=jcfg,
                       pages=jt, page_size=PS)
        lt, tc = TM.decode_step(tp, tc, torch.from_numpy(tok), tcfg,
                                pages=tt, page_size=PS)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **tol,
                                   err_msg=f"{variant} decode {i}")
    toks = rng.integers(1, jcfg.vocab_size, (B, 3))
    lj, pend_j = JM.verify_step(jp, jc, jnp.asarray(toks, jnp.int32), jcfg,
                                pages=jt, page_size=PS)
    lt, pend_t = TM.verify_step(tp, tc, torch.from_numpy(toks), tcfg,
                                pages=tt, page_size=PS)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **tol,
                               err_msg=f"{variant} verify")
    n_acc = np.array([0, 2, 1], np.int32)
    jc = JM.commit_verify(jc, pend_j, jnp.asarray(n_acc), jcfg, pages=jt,
                          page_size=PS)
    tc = TM.commit_verify(tc, pend_t, torch.from_numpy(n_acc), tcfg,
                          pages=tt, page_size=PS)
    got, want = to_numpy(tc), jax.device_get(jc)
    np.testing.assert_array_equal(got["pos"], np.asarray(want["pos"]))
    for pn, layer in want["stack"].items():
        for k, a in layer.items():
            np.testing.assert_allclose(got["stack"][pn][k],
                                       np.asarray(a, np.float32), **tol,
                                       err_msg=f"{variant} commit {pn}/{k}")


# ---------------------------------------------------------------------------
# engines (the port alone)
# ---------------------------------------------------------------------------


def _drive(eng, cfg, n_new=6):
    """Mixed widths and a depth switch, short and long prompts (both
    admission paths), then two requests sharing a 2-page prefix; paged
    engines check their page accounting after every tick."""
    modes = eng.ctrl.modes
    full = modes[-1]
    widths = [m for m in modes if m.depth == full.depth]
    shallow = [m for m in modes if m.depth != full.depth]
    rid = 0
    for m in (widths[-1], widths[0], shallow[-1], widths[-1]):
        eng.set_admission_mode(m)
        plen = 1 + rid % 5
        eng.submit(TS.Request(
            rid=rid, max_new_tokens=n_new,
            prompt=tuple(1 + (rid * 7 + j) % (cfg.vocab_size - 1)
                         for j in range(plen)),
            slo_class="interactive" if rid % 2 else "batch"))
        rid += 1
        eng.step()
        if eng.paged is not None:
            eng.check_paged_invariants()
    prefix = tuple(1 + (j * 3) % (cfg.vocab_size - 1) for j in range(9))
    for _ in range(2):
        eng.submit(TS.Request(rid=rid, prompt=prefix, max_new_tokens=n_new))
        rid += 1
    while eng.queue or eng.n_active:
        eng.step()
        if eng.paged is not None:
            eng.check_paged_invariants()
    return {r.rid: tuple(r.generated) for r in eng.completed}


def _pair(cfg, *, fused=False, speculative=None, batch=3, capacity=32):
    params = TM.init_params(cfg, seed=0, device="cpu")
    out = []
    for paged in (None, TP.PagedLayout(page_size=PS)):
        eng = TS.ServingEngine(params, cfg, batch_size=batch,
                               cache_capacity=capacity, prefill_threshold=4,
                               speculative=speculative, paged=paged,
                               fused=fused, device="cpu")
        eng.warmup()
        out.append(eng)
    return out


def _assert_identical(dense, paged, cfg):
    built = paged.ctrl.trace_counter["n"]
    out_d = _drive(dense, cfg)
    out_p = _drive(paged, cfg)
    assert out_p == out_d
    assert len(out_p) == 6 and all(len(t) == 6 for t in out_p.values())
    assert paged.ctrl.trace_counter["n"] == built, "a paged step was rebuilt"
    assert paged.ctrl.stats["compiles"] == paged.compiles_after_warmup
    return out_p


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_paged_engine_token_identical_to_dense(variant):
    """Plain serving, unfused and fused: the paged engine emits the dense
    engine's tokens on the same trace, with nothing built after warmup.
    With full attention the shared-prefix pair hits the radix."""
    _, cfg = _cfgs(variant)
    for fused in (False, True):
        dense, paged = _pair(cfg, fused=fused)
        _assert_identical(dense, paged, cfg)
        if not cfg.sliding_window:
            st = paged.page_pool_stats()
            assert max(s["radix_hits"] for s in st.values()) >= 2
        assert paged.decode_launches > 0


@pytest.mark.parametrize("fused", [False, True])
def test_paged_speculative_engine_token_identical(fused):
    """Greedy linear speculation (K = 2) reads and writes through the page
    table and trims rejected drafts' pages; its tokens equal the dense
    speculative engine's."""
    _, cfg = _cfgs("full")
    dense, paged = _pair(cfg, fused=fused, speculative=SpecConfig(ks=(2,)))
    _assert_identical(dense, paged, cfg)
    assert paged.spec_verify_launches > 0


def test_shared_prefix_maps_the_same_physical_pages():
    """Two concurrent requests whose prompts share a 2-page prefix map their
    first table entries onto the same physical pages: refcount 3 (two
    slots and the radix tree), the divergence page private, and only the
    tree's reference left once both finish."""
    _, cfg = _cfgs("full")
    params = TM.init_params(cfg, seed=0, device="cpu")
    eng = TS.ServingEngine(params, cfg, batch_size=2, cache_capacity=32,
                           prefill_threshold=4,
                           paged=TP.PagedLayout(page_size=PS), device="cpu")
    eng.warmup()
    prefix = tuple(1 + (j * 3) % (cfg.vocab_size - 1) for j in range(2 * PS))
    eng.submit(TS.Request(rid=0, prompt=prefix + (5,), max_new_tokens=8))
    eng.submit(TS.Request(rid=1, prompt=prefix + (9,), max_new_tokens=8))
    eng.step()
    g = next(g for g in eng.groups.values()
             if sum(r is not None for r in g.slots) == 2)
    pg = g.paging
    slots = [i for i, r in enumerate(g.slots) if r is not None]
    a, b = (pg.table[i, :2] for i in slots)
    assert np.array_equal(a, b), "a shared prefix must map the same pages"
    for pid in a:
        assert pg.alloc.refcount[int(pid)] == 3
    assert pg.table[slots[0], 2] != pg.table[slots[1], 2]
    eng.check_paged_invariants()
    while eng.queue or eng.n_active:
        eng.step()
        eng.check_paged_invariants()
    for pid in a:
        assert pg.alloc.refcount[int(pid)] == 1
    assert all(len(r.generated) == 8 for r in eng.completed)
    m = eng.export_metrics()
    assert any(k.startswith(f"kv_pool_d{g.depth}_radix_hits")
               for k in m["gauges"])


def test_bucketed_page_counts_share_steps():
    """Slots whose page counts cross bucket boundaries (1 + 24 tokens:
    pages 1 -> 7, buckets 1, 2, 4 and 8) re-dispatch the steps built at
    warmup: nothing is built after it."""
    _, cfg = _cfgs("full")
    params = TM.init_params(cfg, seed=0, device="cpu")
    eng = TS.ServingEngine(params, cfg, batch_size=2, cache_capacity=32,
                           prefill_threshold=4,
                           paged=TP.PagedLayout(page_size=PS), device="cpu")
    eng.warmup()
    built, compiles = eng.ctrl.trace_counter["n"], eng.ctrl.stats["compiles"]
    used = set()
    aux = eng.ctrl.aux_step

    def record(key):
        used.add(key)
        return aux(key)

    eng.ctrl.aux_step = record
    eng.submit(TS.Request(rid=0, prompt=(3,), max_new_tokens=24))
    eng.submit(TS.Request(rid=1, prompt=(4, 5), max_new_tokens=20))
    while eng.queue or eng.n_active:
        eng.step()
        eng.check_paged_invariants()
    assert {k[2] for k in used if k[0] == "paged_decode"} == {1, 2, 4, 8}
    assert eng.ctrl.stats["compiles"] == compiles == eng.compiles_after_warmup
    assert eng.ctrl.trace_counter["n"] == built
    assert all(len(r.generated) == r.max_new_tokens for r in eng.completed)


def test_undersized_pool_is_a_hard_error():
    """A request that can never fit the pool is rejected at submit; growing
    a slot past what the pool holds is the allocator's hard error; a bad
    page geometry is refused when the engine is built."""
    _, cfg = _cfgs("full")
    params = TM.init_params(cfg, seed=0, device="cpu")
    # 2 scratch pages + 1 spare: a 3-page prompt can never be admitted
    eng = TS.ServingEngine(params, cfg, batch_size=2, cache_capacity=32,
                           prefill_threshold=4,
                           paged=TP.PagedLayout(page_size=PS, n_pages=3),
                           device="cpu")
    eng.warmup()
    with pytest.raises(ValueError, match="never be admitted"):
        eng.submit(TS.Request(rid=0, prompt=tuple(range(1, 12)),
                              max_new_tokens=4))
    g = next(iter(eng.groups.values()))
    with pytest.raises(RuntimeError, match="exhausted"):
        for _ in range(4):
            g.paging._alloc_page()
    _, swa = _cfgs("swa")
    with pytest.raises(ValueError, match="sliding window"):
        TS.ServingEngine(params, swa, batch_size=2, cache_capacity=30,
                         paged=TP.PagedLayout(page_size=3), device="cpu")
