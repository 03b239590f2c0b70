"""The port's token-tree serving engine against the JAX package's.

Same weights in both packages (JAX init, converted through numpy), f32
smoke configs, 3 slots, capacity 32, prefill threshold 4, the drive of
``tests/test_serving_paged.py`` (mixed widths and a depth switch, short and
long prompts, then two requests sharing a 2-page prefix), greedy, tree
``(2, 1)`` (the case of ``test_serving_paged.py::
test_paged_speculative_token_identical``):

* the port's tree engines emit exactly the JAX tree engine's tokens and the
  port's plain engine's, TinyLlama unfused and fused over a dense and a
  block-paged cache (page 4, page accounting checked after every tick) and
  Mamba2 unfused and fused; each builds one tree draft per exit and one
  tree verify per speculating depth at warmup and nothing after;
* tree and linear shapes share one warmup and switch per tick; a tree near
  the cache's capacity gives way to plain steps; sampled tree serving is
  reproducible from its seed; the SLO policy's tree / linear / plain
  choice and the run summary's tree counter;
* parameters that require grad (fresh from training) serve the tokens of
  detached ones, and no cache tensor picks up a grad_fn;
* ``launch.serve --spec-tree`` on the CPU.
"""
import copy

import jax
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.models import model as JM
from repro.runtime import serving as JS
from repro.runtime import speculative as JSP
from repro_torch.configs import smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.models import model as TM
from repro_torch.models.paged import PagedLayout
from repro_torch.runtime import serving as TS
from repro_torch.runtime import speculative as TSP
from torch_threads import one_thread  # noqa: E402,F401  (autouse)

TREE = (2, 1)
KW = dict(batch_size=3, cache_capacity=32, prefill_threshold=4)
ARCHS = ("tinyllama-1.1b", "mamba2-370m")


def _drive(eng, vocab, n_new=6):
    """The drive of ``tests/test_serving_paged.py``: four admissions at
    (full, narrow, shallow, full) modes with prompts of 1-4 tokens, then two
    requests sharing a 9-token prefix; paged engines check their page
    accounting after every tick."""
    modes = eng.ctrl.modes
    full = modes[-1]
    widths = [m for m in modes if m.depth == full.depth]
    shallow = [m for m in modes if m.depth != full.depth]
    rid = 0

    def tick():
        eng.step()
        if eng.paged is not None:
            eng.check_paged_invariants()

    for m in (widths[-1], widths[0], shallow[-1], widths[-1]):
        eng.set_admission_mode(m)
        eng.submit(type_req(eng)(
            rid=rid, max_new_tokens=n_new,
            prompt=tuple(1 + (rid * 7 + j) % (vocab - 1)
                         for j in range(1 + rid % 5)),
            slo_class="interactive" if rid % 2 else "batch"))
        rid += 1
        tick()
    prefix = tuple(1 + (j * 3) % (vocab - 1) for j in range(9))
    for _ in range(2):
        eng.submit(type_req(eng)(rid=rid, prompt=prefix,
                                 max_new_tokens=n_new))
        rid += 1
    while eng.queue or eng.n_active:
        tick()
    return {r.rid: tuple(r.generated) for r in eng.completed}


def type_req(eng):
    return JS.Request if isinstance(eng, JS.ServingEngine) else TS.Request


_STREAMS = {}


def _reference(arch):
    """(JAX params, JAX tree engine streams, port plain engine streams)."""
    if arch not in _STREAMS:
        jcfg = jax_smoke_config(arch)
        jp = jax.device_get(JM.init_params(jax.random.PRNGKey(0), jcfg))
        eng = JS.ServingEngine(jp, jcfg, speculative=JSP.SpecConfig(
            ks=(), trees=(TREE,)), **KW)
        eng.warmup()
        want = _drive(eng, jcfg.vocab_size)
        assert eng.spec_tree_launches > 0
        plain = TS.ServingEngine(params_from_jax(jp, device="cpu"),
                                 smoke_config(arch), device="cpu", **KW)
        plain.warmup()
        _STREAMS[arch] = (jp, want, _drive(plain, jcfg.vocab_size))
    return _STREAMS[arch]


@pytest.mark.parametrize("arch,fused,paged", [
    ("tinyllama-1.1b", False, False), ("tinyllama-1.1b", True, False),
    ("tinyllama-1.1b", False, True), ("tinyllama-1.1b", True, True),
    ("mamba2-370m", False, False), ("mamba2-370m", True, False)],
    ids=["tinyllama-unfused", "tinyllama-fused", "tinyllama-unfused-paged",
         "tinyllama-fused-paged", "mamba2-unfused", "mamba2-fused"])
def test_greedy_tree_engine_matches_jax_and_plain(arch, fused, paged):
    jp, want, plain = _reference(arch)
    cfg = smoke_config(arch)
    eng = TS.ServingEngine(
        params_from_jax(jp, device="cpu"), cfg, fused=fused,
        paged=PagedLayout(page_size=4) if paged else None,
        speculative=TSP.SpecConfig(ks=(), trees=(TREE,)), device="cpu", **KW)
    eng.warmup()
    depths = {m.depth for m in eng.ctrl.modes}
    steps = len(depths) * (1 + (len(eng._buckets) if paged else 0))
    # one decode step per depth (paged: and per bucket), one tree draft at
    # the shared exit, one tree verify per speculating depth
    assert eng.compiles_after_warmup == steps + 1 + len(depths) - 1
    built = eng.ctrl.trace_counter["n"]
    got = _drive(eng, cfg.vocab_size)
    assert got == want == plain
    assert eng.ctrl.stats["compiles"] == eng.compiles_after_warmup
    assert eng.ctrl.trace_counter["n"] == built
    assert eng.spec_tree_launches == eng.spec_verify_launches > 0
    (path, tel), = eng.spec_telemetry_summary().items()
    assert path == f"d{max(depths)}<-d{min(depths)}t2x1"
    assert tel["tree"] == "2x1" and tel["draft_nodes"] == 4
    assert tel["tokens_per_slot_launch"] >= 1.0


def test_tree_and_linear_shapes_share_one_warmup():
    """ks and trees are built side by side at warmup; switching a group
    between them every tick re-dispatches and builds nothing."""
    cfg = smoke_config("tinyllama-1.1b")
    eng = TS.ServingEngine(TM.init_params(cfg, seed=0, device="cpu"), cfg,
                           speculative=TSP.SpecConfig(ks=(2,),
                                                      trees=(TREE,)),
                           device="cpu", **KW)
    eng.warmup()
    depths = {m.depth for m in eng.ctrl.modes}
    assert eng.compiles_after_warmup == len(depths) + 2 * len(depths)
    built = eng.ctrl.trace_counter["n"]
    g = eng.groups[max(depths)]
    assert g.spec_tree == TREE  # a tree is the optimistic default
    for rid, plen in enumerate((1, 3, 5, 1)):
        eng.submit(TS.Request(rid=rid, prompt=tuple(range(1, 1 + plen)),
                              max_new_tokens=8))
    flip = 0
    while eng.queue or eng.n_active:
        g.spec_tree, g.spec_k = ((None, 2) if flip % 2 else (TREE, 0))
        flip += 1
        eng.step()
    assert eng.ctrl.trace_counter["n"] == built
    assert eng.ctrl.stats["compiles"] == eng.compiles_after_warmup
    assert eng.spec_verify_launches > eng.spec_tree_launches > 0
    assert {p[-2:] for p in eng.spec_telemetry_summary()} == {"k2", "x1"}


def test_tree_respects_capacity_headroom():
    """A (2, 2) tree needs 3 free positions past a slot's fed tokens; near
    capacity the group steps plainly, and a paged engine reserves the
    tree's depth of headroom at admission."""
    cfg = smoke_config("tinyllama-1.1b")
    params = TM.init_params(cfg, seed=0, device="cpu")
    spec = TSP.SpecConfig(ks=(), trees=((2, 2),))
    eng = TS.ServingEngine(params, cfg, batch_size=1, cache_capacity=12,
                           prefill_threshold=100, speculative=spec,
                           device="cpu")
    eng.warmup()
    eng.submit(TS.Request(rid=0, prompt=(3,), max_new_tokens=12))
    while eng.queue or eng.n_active:
        eng.step()
    assert len(eng.completed[0].generated) == 12
    assert eng.decode_launches > 0 and eng.spec_tree_launches > 0
    paged = TS.ServingEngine(params, cfg, batch_size=1, cache_capacity=12,
                             paged=PagedLayout(page_size=4),
                             speculative=spec, device="cpu")
    g = paged.groups[cfg.n_groups]
    req = TS.Request(rid=1, prompt=(3, 4), max_new_tokens=4)
    # highest write position 2 + 4 - 2 plus the tree's 2 levels
    assert paged._worst_case_pages(g, req) == (2 + 4 - 2 + 2) // 4 + 1


def test_sampled_tree_engine_is_reproducible():
    """temperature 0.8, top-k 8, fused: every stream completes in-vocab,
    and a second engine with the same seed emits the same streams."""
    cfg = smoke_config("tinyllama-1.1b")
    params = TM.init_params(cfg, seed=0, device="cpu")
    runs = []
    for _ in range(2):
        eng = TS.ServingEngine(params, cfg, temperature=0.8, top_k=8,
                               fused=True, sample_seed=5, device="cpu",
                               speculative=TSP.SpecConfig(ks=(),
                                                          trees=((2, 2),)),
                               **KW)
        eng.warmup()
        runs.append(_drive(eng, cfg.vocab_size))
        assert eng.spec_tree_launches > 0 and eng.speculative.top_k == 8
        assert all(len(s) == 6 and all(0 <= t < cfg.vocab_size for t in s)
                   for s in runs[-1].values())
    assert runs[0] == runs[1]


def test_choose_tree_policy_and_run_summary():
    cfg = smoke_config("tinyllama-1.1b")
    eng = TS.ServingEngine(TM.init_params(cfg, seed=0, device="cpu"), cfg,
                           speculative=TSP.SpecConfig(ks=(2,),
                                                      trees=((2, 2), TREE)),
                           device="cpu", **KW)
    eng.warmup()
    pol = TS.SLOPolicy(cfg, eng.ctrl, batch_size=3, cache_capacity=32)
    trees, ks = [(2, 2), TREE], [2, 4]
    kind, shape = pol.choose_tree(trees, ks, accept_rate=0.4)
    assert kind == "tree"
    k2, s2 = pol.choose_tree(trees, ks, accept_rate=0.4,
                             queue_depths={"interactive": 200, "batch": 200})
    budget = TSP.tree_node_budget(s2) if k2 == "tree" else s2
    assert budget <= TSP.tree_node_budget(shape)
    assert pol.choose_tree(trees, ks, accept_rate=0.0) == ("plain", None)
    assert pol.choose_tree([], [], accept_rate=0.9) == ("plain", None)
    jcfg = jax_smoke_config("tinyllama-1.1b")
    jeng = JS.ServingEngine(JM.init_params(jax.random.PRNGKey(0), jcfg),
                            jcfg, batch_size=3, cache_capacity=32)
    jpol = JS.SLOPolicy(jcfg, jeng.ctrl, batch_size=3, cache_capacity=32)
    for rate in (0.03, 0.2, 0.4, 0.8):
        for qd in (None, {"batch": 3}, {"interactive": 40}):
            assert pol.choose_tree(trees, ks, rate, qd) == \
                jpol.choose_tree(trees, ks, rate, qd)
    trace = TS.poisson_trace(4, 1000.0, seed=0, prompt_len=(1, 3),
                             new_tokens=(3, 6), vocab=cfg.vocab_size)
    out = eng.run(trace, budget_fn=lambda t: 10.0, policy=pol)
    assert out["completed"] == 4 and out["compiles"] == eng.compiles_after_warmup
    assert out["spec_tree_launches"] == eng.spec_tree_launches > 0
    m = eng.export_metrics()
    assert m["counters"]["engine_spec_tree_launches"] == eng.spec_tree_launches


@pytest.mark.parametrize("arch", ARCHS)
def test_params_that_require_grad_serve(arch):
    """Parameters that require grad (as training returns them) serve the
    tokens of detached ones, plain, linear-speculative and tree-speculative,
    and no cache tensor picks up a grad_fn: the engine's warmup and ticks
    run under ``torch.no_grad()``."""
    cfg = smoke_config(arch)
    params = TM.init_params(cfg, seed=1, device="cpu")

    def leaves(tree):
        for v in tree.values():
            yield from (leaves(v) if isinstance(v, dict) else (v,))

    trained = copy.deepcopy(params)
    for t in leaves(trained):
        if t.is_floating_point():
            t.requires_grad_(True)
    for spec in (None, TSP.SpecConfig(ks=(2,)),
                 TSP.SpecConfig(ks=(), trees=(TREE,))):
        runs = []
        for p in (params, trained):
            eng = TS.ServingEngine(p, cfg, speculative=spec, device="cpu",
                                   **KW)
            eng.warmup()
            runs.append(_drive(eng, cfg.vocab_size, n_new=4))
            for g in eng.groups.values():
                for t in leaves(g.cache["stack"]):
                    assert t.grad_fn is None and not t.requires_grad
        assert runs[0] == runs[1], spec


def test_serve_cli_spec_tree_on_cpu(capsys):
    from repro_torch.launch.serve import main

    assert main(["--arch", "tinyllama-1.1b", "--smoke", "--batch", "2",
                 "--tokens", "12", "--device", "cpu", "--spec-tree", "2x1",
                 "--spec-k", "2", "--kv-page-size", "4", "--fused"]) == 0
    out = capsys.readouterr().out
    assert "recompiles_after_warmup=0" in out and "spec_tree=2x1" in out
    assert "tree 2x1 (4 draft nodes)" in out and "pages depth=3" in out
    assert main(["--arch", "mamba2-370m", "--smoke", "--batch", "2",
                 "--tokens", "12", "--device", "cpu", "--spec-tree",
                 "2x1"]) == 0
    assert "spec d3<-d1t2x1" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        main(["--arch", "tinyllama-1.1b", "--smoke", "--device", "cpu",
              "--spec-tree", "2x0"])
