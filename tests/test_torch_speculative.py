"""The port's speculative decoding and sampling against the JAX package.

Same weights in both packages (JAX init, converted through numpy), f32 smoke
config (3 groups, H = 4, KV = 2, hd = 16), inputs from numpy seeds:

* ``verify_step`` logits and pending K/V vs JAX ``verify_step`` at atol
  1e-4 (full attention, int8 KV, sliding window; mixed widths; unfused and
  ``fused=True``, whose CPU path is ``fused_verify_plain``);
* ``commit_verify`` for every acceptance count 0..K equals n+1 sequential
  ``decode_step`` calls: logits and the whole cache (atol 3e-5, int8
  values exactly), as ``tests/test_speculative.py`` holds JAX to;
* ``accept_speculative`` at temperature 0 vs JAX on the same logits:
  identical tokens and counts;
* the sampling properties ``tests/test_sampling.py`` asserts for JAX, plus a
  frequency test against ``token_dist`` (total variation below 0.05 over
  4000 draws);
* the greedy speculative engine emits exactly the port's plain engine's
  streams and the JAX speculative engine's, on one trace with mixed widths
  and depth switches; every top-1 margin that chose a token exceeds the
  logit tolerance tenfold, and nothing is built after warmup.
"""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.core import elastic as jax_elastic
from repro.models import model as JM
from repro.runtime import serving as JS
from repro.runtime import speculative as JSP
from repro_torch.configs import smoke_config
from repro_torch.convert import cache_from_jax, params_from_jax, to_numpy
from repro_torch.core import elastic
from repro_torch.models import model as TM
from repro_torch.runtime import sampling as TSA
from repro_torch.runtime import serving as TS
from repro_torch.runtime import speculative as TSP
from torch_threads import one_thread  # noqa: E402,F401  (autouse)

ATOL = 1e-4
VARIANTS = {"full": {}, "kv_quant": {"kv_quant": True},
            "swa": {"sliding_window": 5}}
WINDOW = np.array([[2, 9, 4, 6], [7, 3, 2, 1]], np.int64)  # (B, K+1)


def _cfgs(variant):
    kw = VARIANTS[variant]
    return (dataclasses.replace(jax_smoke_config("tinyllama-1.1b"), **kw),
            dataclasses.replace(smoke_config("tinyllama-1.1b"), **kw))


@pytest.fixture(scope="module")
def jax_params():
    jcfg, _ = _cfgs("full")
    return jax.device_get(JM.init_params(jax.random.PRNGKey(0), jcfg))


def _port_cache(tp, tcfg, active, n_warm):
    """A per-slot port cache after ``n_warm`` decode steps (past the
    sliding window when it has one, so the buffer has rolled)."""
    cache = TM.init_decode_cache(tcfg, 2, 16, per_slot=True, device="cpu")
    for t in range(n_warm):
        tok = torch.tensor([[3 + t], [5 + t]])
        _, cache = TM.decode_step(tp, cache, tok, tcfg, active=active)
    return cache


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_verify_step_matches_jax(jax_params, variant):
    jcfg, tcfg = _cfgs(variant)
    ja = jax_elastic.active_widths_batch(jcfg, [0.5, 1.0])
    jcache = JM.init_decode_cache(jcfg, 2, 16, per_slot=True)
    step = jax.jit(JM.decode_step, static_argnames=("cfg",))
    n_warm = 7 if jcfg.sliding_window else 3
    for t in range(n_warm):
        _, jcache = step(jax_params, jcache,
                         jnp.asarray([[3 + t], [5 + t]], jnp.int32),
                         cfg=jcfg, active=ja)
    jl, jp = jax.jit(JM.verify_step, static_argnames=("cfg",))(
        jax_params, jcache, jnp.asarray(WINDOW, jnp.int32), cfg=jcfg,
        active=ja)
    tp = params_from_jax(jax_params, device="cpu")
    ta = elastic.active_widths_batch(tcfg, [0.5, 1.0], device="cpu")
    for fused in (False, True):
        tc = cache_from_jax(jax.device_get(jcache), device="cpu")
        before = to_numpy(tc)
        tl, tpend = TM.verify_step(tp, tc, torch.from_numpy(WINDOW), tcfg,
                                   active=ta, fused=fused)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   rtol=0, err_msg=f"fused={fused} logits")
        for pn, layer in jax.device_get(jp)["stack"].items():
            for k, a in layer.items():
                np.testing.assert_allclose(
                    tpend["stack"][pn][k].numpy(), np.asarray(a), atol=ATOL,
                    rtol=0, err_msg=f"fused={fused} pending {pn}/{k}")
        after = to_numpy(tc)  # verify never writes the cache
        for pn in before["stack"]:
            for k in before["stack"][pn]:
                np.testing.assert_array_equal(after["stack"][pn][k],
                                              before["stack"][pn][k])


def _clone(cache):
    return {"pos": cache["pos"].clone(),
            "stack": {pn: {k: t.clone() for k, t in layer.items()}
                      for pn, layer in cache["stack"].items()}}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_commit_verify_equals_sequential_decode(variant):
    """For every n in 0..K, committing the K+1-position pass at n gives the
    cache (and the logits) of n+1 chained decode steps, at the exit depth
    and at full depth, with mixed widths; the commit works in place."""
    _, tcfg = _cfgs(variant)
    tp = TM.init_params(tcfg, seed=1, device="cpu")
    ta = elastic.active_widths_batch(tcfg, [0.5, 1.0], device="cpu")
    cache = _port_cache(tp, tcfg, ta, 7 if tcfg.sliding_window else 3)
    K = WINDOW.shape[1] - 1
    for depth in (1, tcfg.n_groups):
        logits, pending = TM.verify_step(tp, cache, torch.from_numpy(WINDOW),
                                         tcfg, depth=depth, active=ta)
        for n in range(K + 1):
            committed = _clone(cache)
            out = TM.commit_verify(committed, pending,
                                   torch.full((2,), n, dtype=torch.int32),
                                   tcfg)
            assert out is committed
            ref = _clone(cache)
            for t in range(n + 1):
                lr, ref = TM.decode_step(
                    tp, ref, torch.from_numpy(WINDOW[:, t:t + 1]), tcfg,
                    depth=depth, active=ta)
            np.testing.assert_allclose(logits[:, n].numpy(),
                                       lr[:, 0].numpy(), atol=3e-5,
                                       rtol=1e-5, err_msg=f"d{depth} n{n}")
            got, want = to_numpy(committed), to_numpy(ref)
            np.testing.assert_array_equal(got["pos"], want["pos"])
            for pn, layer in want["stack"].items():
                for k, a in layer.items():
                    np.testing.assert_allclose(
                        got["stack"][pn][k], a, atol=3e-5, rtol=1e-5,
                        err_msg=f"d{depth} n{n} {pn}/{k}")


def test_accept_speculative_greedy_matches_jax():
    rng = np.random.default_rng(5)
    B, K, Vp, V = 4, 3, 40, 37
    logits = rng.standard_normal((B, K + 1, Vp)).astype(np.float32)
    dlog = rng.standard_normal((B, K, Vp)).astype(np.float32)
    drafts = dlog[..., :V].argmax(-1)
    # make the verifier agree with the draft on a slot-dependent prefix, so
    # every count 0..K occurs
    for b in range(B):
        for j in range(min(b, K)):
            logits[b, j, drafts[b, j]] = 10.0
    logits[:, :, V:] = 50.0  # padded vocab never wins
    tokens = np.concatenate([np.full((B, 1), 7), drafts], axis=1)
    j_out, j_n = jax.jit(JSP.accept_speculative, static_argnums=(5,))(
        jnp.asarray(logits), jnp.asarray(dlog), jnp.asarray(tokens, jnp.int32),
        JSP.sampling.make_slot_keys(0, B), 0.0, V)
    t_out, t_n = TSP.accept_speculative(
        torch.from_numpy(logits), torch.from_numpy(dlog),
        torch.from_numpy(tokens), TSA.make_slot_keys(0, B), 0.0, V)
    np.testing.assert_array_equal(t_n.numpy(), np.asarray(j_n))
    np.testing.assert_array_equal(t_out.numpy(), np.asarray(j_out))
    assert sorted(t_n.tolist()) == [0, 1, 2, 3]


def test_draft_leaves_the_committed_cache_untouched():
    _, tcfg = _cfgs("full")
    tp = TM.init_params(tcfg, seed=2, device="cpu")
    ta = elastic.active_widths_batch(tcfg, [1.0, 0.5], device="cpu")
    cache = _port_cache(tp, tcfg, ta, 3)
    before = to_numpy(cache)
    draft = TSP.make_draft_step(tcfg, 1, 3)
    keys = TSA.make_slot_keys(0, 2)
    toks, lg = draft(tp, cache, torch.tensor([[4], [6]]), ta, keys, 0.0, 0)
    scratch = draft.scratch
    draft(tp, cache, torch.tensor([[4], [6]]), ta, keys, 0.0, 1)
    assert draft.scratch is scratch  # allocated once, refilled per draft
    assert toks.shape == (2, 3) and lg.shape == (2, 3, tcfg.padded_vocab())
    assert scratch["stack"]["pos0"]["k"].shape[0] == 1  # draft depth only
    after = to_numpy(cache)
    np.testing.assert_array_equal(after["pos"], before["pos"])
    for pn in before["stack"]:
        for k in before["stack"][pn]:
            np.testing.assert_array_equal(after["stack"][pn][k],
                                          before["stack"][pn][k])
    # greedy drafts are the draft depth's own greedy continuation
    ref = _clone(cache)
    tok = torch.tensor([[4], [6]])
    for j in range(3):
        lr, ref = TM.decode_step(tp, ref, tok, tcfg, depth=1, active=ta)
        tok = lr[:, 0, :tcfg.vocab_size].argmax(-1)[:, None]
        assert torch.equal(tok[:, 0], toks[:, j])


# ---------------------------------------------------------------------------
# sampling properties
# ---------------------------------------------------------------------------


def _logits(seed, B, V):
    return torch.from_numpy(
        np.random.default_rng(seed).standard_normal((B, V)).astype(np.float32))


def test_temperature_zero_and_top_k_one_are_argmax():
    lg = _logits(1, 6, 50)
    lg[0, 3] = lg[0, 9] = 40.0  # an exact tie: the first index wins
    keys = TSA.make_slot_keys(3, 6)
    want = lg.argmax(-1)
    assert want[0] == 3
    assert torch.equal(TSA.sample_tokens(lg, keys, 0.0, 50), want)
    assert torch.equal(TSA.sample_tokens(lg, keys, 0.9, 50, top_k=1), want)
    d = TSA.token_dist(lg, 0.0, 50)
    assert torch.equal(d, torch.nn.functional.one_hot(want, 50).float())


def test_top_k_geq_vocab_is_noop_and_support_is_top_k():
    lg = _logits(2, 3, 20)
    for k in (20, 64):
        assert torch.equal(TSA.token_dist(lg, 0.7, 20, top_k=k),
                           TSA.token_dist(lg, 0.7, 20))
    d = TSA.token_dist(lg, 1.0, 20, top_k=4)
    assert ((d > 0).sum(-1) == 4).all()
    top = torch.topk(lg, 4, dim=-1).indices
    assert bool((d.gather(-1, top) > 0).all())
    keys = TSA.fold_step(TSA.make_slot_keys(0, 3), torch.arange(200)[:, None])
    draws = TSA.sample_tokens(lg.repeat(200, 1), keys.reshape(-1), 1.0, 20,
                              top_k=4).view(200, 3)
    assert bool((draws.T[..., None] == top[:, None, :]).any(-1).all())


def test_padded_vocab_never_sampled():
    lg = _logits(3, 4, 24)
    lg[:, 17:] = 100.0  # padded columns carry garbage
    d = TSA.token_dist(lg, 1.0, 17)
    assert d.shape == (4, 17)
    torch.testing.assert_close(d.sum(-1), torch.ones(4))
    keys = TSA.make_slot_keys(1, 4)
    for step in range(10):
        s = TSA.sample_tokens(lg, TSA.fold_step(keys, step), 1.0, 17)
        assert bool((s < 17).all())
    assert bool((TSA.sample_tokens(lg, keys, 0.0, 17) < 17).all())


def test_streams_deterministic_and_independent_of_batch_composition():
    lg = _logits(4, 5, 64)
    keys = TSA.fold_step(TSA.make_slot_keys(7, 5), 11)
    full = TSA.sample_tokens(lg, keys, 0.9, 64)
    assert torch.equal(full, TSA.sample_tokens(lg, keys, 0.9, 64))
    for b in range(5):
        solo = TSA.sample_tokens(lg[b:b + 1], keys[b:b + 1], 0.9, 64)
        assert solo[0] == full[b]
    assert len(set(TSA.make_slot_keys(0, 8).tolist())) == 8
    uni = torch.zeros(2, 4096)
    base = TSA.sample_tokens(uni, TSA.make_slot_keys(0, 2), 1.0, 4096)
    other = TSA.sample_tokens(uni, TSA.make_slot_keys(1, 2), 1.0, 4096)
    salted = TSA.sample_tokens(uni, TSA.make_slot_keys(0, 2), 1.0, 4096,
                               salt=3)
    assert not torch.equal(base, other) and not torch.equal(base, salted)


def test_sampled_frequencies_track_token_dist():
    """Total-variation distance between 4000 draws (one key, folded with
    the step) and ``token_dist`` stays below 0.05."""
    lg = torch.tensor([[0.0, 1.0, 2.0, -1.0, 0.5]])
    n = 4000
    keys = TSA.fold_step(TSA.make_slot_keys(11, 1), torch.arange(n))
    draws = TSA.sample_tokens(lg.expand(n, 5), keys, 0.8, 5)
    emp = torch.bincount(draws, minlength=5).float() / n
    ref = TSA.token_dist(lg, 0.8, 5)[0]
    assert 0.5 * float((emp - ref).abs().sum()) < 0.05, (emp, ref)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

SCHEDULE = ("d3w100", "d3w50", "d1w100", "d3w100", "d1w50", "d3w50")
SPEC = dict(ks=(3,), min_accept_rate=0.0)


def _drive(engine, reqs):
    """One request submitted per tick and the admission mode moved every
    tick along SCHEDULE."""
    pending = list(reqs)
    while pending or engine.queue or engine.n_active:
        if pending:
            engine.submit(pending.pop(0))
        sched = SCHEDULE[engine.step_count % len(SCHEDULE)]
        engine.set_admission_mode(engine.ctrl.mode_by_name[sched])
        engine.step()
    return {r.rid: list(r.generated) for r in reqs}


def _trace(vocab):
    return JS.poisson_trace(7, 100.0, seed=4, prompt_len=(1, 6),
                            new_tokens=(4, 12), vocab=vocab)


@pytest.fixture(scope="module")
def jax_spec_streams(jax_params):
    jcfg, _ = _cfgs("full")
    eng = JS.ServingEngine(jax_params, jcfg, batch_size=3, cache_capacity=24,
                           prefill_threshold=3,
                           speculative=JSP.SpecConfig(**SPEC))
    eng.warmup()
    out = _drive(eng, copy.deepcopy(_trace(jcfg.vocab_size)))
    assert eng.spec_verify_launches > 0
    return out


def _margins(eng, cfg):
    """Record the top-1 margin of every logit row that picked a token."""
    margins = []

    def top1(rows):
        top = torch.topk(rows[..., : cfg.vocab_size].float(), 2, dim=-1)
        margins.append(float((top.values[..., 0] - top.values[..., 1]).min()))

    timed, pre, tick = eng.ctrl.timed_step, eng._prefill_launch, eng._spec_tick
    seen = {}
    accept = TSP.accept_speculative

    def accept_spy(logits, *a, **k):
        out, n_acc = accept(logits, *a, **k)
        seen["last"] = (logits, n_acc)
        return out, n_acc

    def timed_step(*a, **k):
        out = timed(*a, **k)
        g = eng.groups[k["mode"].depth]
        top1(out[0][[i for i, r in enumerate(g.slots) if r is not None]])
        return out

    def prefill_launch(*a, **k):
        logits = pre(*a, **k)
        top1(logits)
        return logits

    def spec_tick(g, k, active_ix, now_s):
        dt = tick(g, k, active_ix, now_s)
        logits, n_acc = seen.pop("last")
        for i in active_ix:
            top1(logits[i, : int(n_acc[i]) + 1])
        return dt

    eng.ctrl.timed_step, eng._prefill_launch = timed_step, prefill_launch
    eng._spec_tick = spec_tick
    return margins, accept_spy


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_greedy_spec_engine_matches_plain_and_jax(jax_params, jax_spec_streams,
                                                  monkeypatch, fused):
    _, tcfg = _cfgs("full")
    tp = params_from_jax(jax_params, device="cpu")
    trace = _trace(tcfg.vocab_size)
    kw = dict(batch_size=3, cache_capacity=24, prefill_threshold=3,
              fused=fused, device="cpu")
    plain = TS.ServingEngine(tp, tcfg, **kw)
    plain.warmup()
    m_plain, _ = _margins(plain, tcfg)
    want = _drive(plain, copy.deepcopy(trace))

    eng = TS.ServingEngine(tp, tcfg, speculative=TSP.SpecConfig(**SPEC), **kw)
    eng.warmup()
    depths = {m.depth for m in eng.ctrl.modes}
    # one step per depth, one draft (the shared exit), one verify per
    # speculating depth
    assert eng.compiles_after_warmup == len(depths) + 1 + len(depths) - 1
    built = eng.ctrl.trace_counter["n"]
    assert built == eng.compiles_after_warmup
    m_spec, spy = _margins(eng, tcfg)
    monkeypatch.setattr(TSP, "accept_speculative", spy)
    got = _drive(eng, copy.deepcopy(trace))
    assert got == want == jax_spec_streams
    assert min(m_plain + m_spec) > 10 * ATOL, min(m_plain + m_spec)
    assert eng.spec_verify_launches > 0 and eng.decode_launches > 0
    assert eng.ctrl.stats["compiles"] == eng.compiles_after_warmup
    assert eng.ctrl.trace_counter["n"] == built
    (path, tel), = eng.spec_telemetry_summary().items()
    assert path == "d3<-d1k3" and tel["launches"] == eng.spec_verify_launches
    assert tel["tokens_per_slot_launch"] >= 1.0


def test_sampled_spec_engine_is_reproducible():
    """temperature > 0 with top-k: every stream completes with in-vocab
    tokens, and a second engine with the same seed emits the same streams
    (per-slot keys folded with the tick count)."""
    _, tcfg = _cfgs("full")
    tp = TM.init_params(tcfg, seed=0, device="cpu")
    runs = []
    for _ in range(2):
        eng = TS.ServingEngine(tp, tcfg, batch_size=3, cache_capacity=24,
                               prefill_threshold=3, temperature=0.8, top_k=8,
                               speculative=TSP.SpecConfig(**SPEC),
                               sample_seed=5, device="cpu")
        eng.warmup()
        trace = TS.poisson_trace(3, 100.0, seed=1, prompt_len=(1, 4),
                                 new_tokens=(4, 8), vocab=tcfg.vocab_size)
        runs.append(_drive(eng, trace))
        assert eng.spec_verify_launches > 0
        assert eng.speculative.top_k == 8
        for r in trace:
            s = runs[-1][r.rid]
            assert len(s) == r.max_new_tokens
            assert all(0 <= t < tcfg.vocab_size for t in s)
    assert runs[0] == runs[1]


def test_spec_fallback_on_acceptance_collapse():
    _, tcfg = _cfgs("full")
    tp = TM.init_params(tcfg, seed=0, device="cpu")
    eng = TS.ServingEngine(tp, tcfg, batch_size=2, cache_capacity=32,
                           prefill_threshold=4, device="cpu",
                           speculative=TSP.SpecConfig(ks=(2,),
                                                      min_accept_rate=1.1,
                                                      window=3,
                                                      cooloff_ticks=5))
    eng.warmup()
    for rid in range(2):
        eng.submit(TS.Request(rid=rid, prompt=(1 + rid,), max_new_tokens=16))
    while eng.queue or eng.n_active:
        eng.step()
    assert len(eng.spec_fallback_log) >= 1
    step, depth, rate, off_until = eng.spec_fallback_log[0]
    assert rate < 1.1 and off_until == step + 5
    assert eng.decode_launches > 0 and eng.spec_verify_launches >= 3
    assert [len(r.generated) for r in eng.completed] == [16, 16]


def test_choose_spec_k_and_run_summary():
    _, tcfg = _cfgs("full")
    tp = TM.init_params(tcfg, seed=0, device="cpu")
    eng = TS.ServingEngine(tp, tcfg, batch_size=2, cache_capacity=32,
                           speculative=TSP.SpecConfig(ks=(1, 2, 4)),
                           device="cpu")
    eng.warmup()
    policy = TS.SLOPolicy(tcfg, eng.ctrl, batch_size=2, cache_capacity=32)
    assert policy.choose_spec_k((1, 2, 4), 0.3) == 4
    assert policy.choose_spec_k((1, 2, 4), 0.3, {"batch": 64}) == 1
    assert TSP.expected_tokens_per_launch(0.5, 2) == 1.75
    trace = TS.poisson_trace(4, 1000.0, seed=0, prompt_len=(1, 3),
                             new_tokens=(3, 6), vocab=tcfg.vocab_size)
    out = eng.run(trace, budget_fn=lambda t: 10.0, policy=policy)
    assert out["completed"] == 4 and out["compiles"] == eng.compiles_after_warmup
    assert out["spec_verify_launches"] == eng.spec_verify_launches > 0
    m = eng.export_metrics()
    assert m["counters"]["engine_spec_verify_launches"] == \
        eng.spec_verify_launches


def test_tree_parts_raise_naming_the_tree_slice():
    """The tree slice's entry points (ported; held to JAX in
    ``test_torch_tree.py``) refuse malformed trees with an error that names
    what is wrong: a level without children, a token array that is not the
    topology's node count, a spec plan without any draft shape."""
    _, tcfg = _cfgs("full")
    tp = TM.init_params(tcfg, seed=0, device="cpu")
    cache = TM.init_decode_cache(tcfg, 1, 8, per_slot=True, device="cpu")
    topo = TSP.TreeTopology((2, 1))
    assert (topo.n_nodes, topo.n_levels) == (5, 2)
    for fn, err, match in (
            (lambda: TSP.TreeTopology((2, 0)), ValueError, "branching"),
            (lambda: TSP.spec_plan([1, 3], TSP.SpecConfig(ks=())),
             ValueError, "tree schedule"),
            (lambda: TM.verify_tree(tp, cache, torch.zeros((1, 4),
                                                           dtype=torch.int64),
                                    tcfg, tree=topo), ValueError, "nodes"),
            (lambda: TM.draft_tree_level(
                tp, cache, TM.init_tree_draft_carry(tcfg, 1, topo,
                                                    device="cpu"),
                torch.zeros((1, 1), dtype=torch.int64), tcfg, tree=topo,
                level=1), ValueError, "frontier")):
        with pytest.raises(err, match=match):
            fn()
