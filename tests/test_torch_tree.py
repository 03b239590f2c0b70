"""The port's token-tree functions against the JAX package.

Same weights in both packages (JAX init, converted through numpy), f32
smoke configs (TinyLlama: 3 groups, H = 4, KV = 2, hd = 16; Mamba2: 3 SSM
layers), inputs from numpy seeds. The JAX references run once per module
at fixed topologies ((2,), (2, 1), (2, 2), (2, 2, 1), (3, 2, 1)), never
hypothesis-drawn ones:

* ``TreeTopology``'s arrays, ``tree_carry_nodes``, the draft position
  counts, the node budget, ``expected_tokens_per_tree_launch``,
  ``per_candidate_accept_rate`` and ``spec_plan``'s tree table equal JAX's;
* greedy ``accept_tree`` equals JAX's (tokens, path, counts) on logits
  whose top entries are distinct; sampled ``accept_tree``'s first token
  stays within total variation 0.05 of the verifier over 8192 draws;
* a tree draft at temperature > 0 draws each child from the draft key
  folded with the child's index (the batched draw equals one
  ``sample_tokens(salt=c)`` per child), so siblings draw distinct streams;
* ``verify_tree`` logits and per-node candidates (unfused, and fused, whose
  CPU path is ``fused_verify_plain``), ``draft_tree_level`` chained over
  the levels, and ``commit_verify(path_nodes=)`` equal JAX's at atol 1e-4:
  TinyLlama with full attention, int8 KV and a sliding window of 5,
  Mamba2, and TinyLlama over a shuffled page table;
* within the port, the draft's carried rows (K/V, conv tails, states) are
  bit-identical to ``verify_tree``'s candidates for the same nodes, its
  logits too where the unembedding is untied (TinyLlama); Mamba2 ties the
  embedding, and the CPU BLAS product with its transposed matrix sums a
  2-row call in another order than a 22-row one, so there the draft's
  logits are held to atol 1e-6; the committed cache is unchanged by a draft.
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
from repro.models import paged as JP
from repro.runtime import sampling as JSA
from repro.runtime import speculative as JSP
from repro_torch.configs import smoke_config
from repro_torch.convert import cache_from_jax, params_from_jax, to_numpy
from repro_torch.core import elastic
from repro_torch.models import model as TM
from repro_torch.runtime import sampling as TSA
from repro_torch.runtime import speculative as TSP
from torch_threads import one_thread  # noqa: E402,F401  (autouse)

ATOL = 1e-4
TOPOLOGIES = [(2,), (2, 1), (2, 2), (2, 2, 1), (3, 2, 1)]
TREE = (2, 2, 1)
PS = 4
# variant -> (arch, config overrides, paged)
VARIANTS = {"full": ("tinyllama-1.1b", {}, False),
            "kv_quant": ("tinyllama-1.1b", {"kv_quant": True}, False),
            "swa": ("tinyllama-1.1b", {"sliding_window": 5}, False),
            "mamba2": ("mamba2-370m", {}, False),
            "paged": ("tinyllama-1.1b", {}, True)}
# the accepted path and count per slot (B = 2) committed in every variant:
# slot 0 stops after node 2 (its children are 5 and 6), slot 1 walks
# 0 -> 1 -> 3 -> 7 to a leaf
PATH = np.array([[0, 2, 5, 5], [0, 1, 3, 7]], np.int32)
N_ACC = np.array([2, 3], np.int32)

_jverify = jax.jit(JM.verify_tree, static_argnames=("cfg", "tree", "depth",
                                                    "page_size"))
_jlevel = jax.jit(JM.draft_tree_level, static_argnames=(
    "cfg", "tree", "level", "depth", "page_size"))
_jcommit = jax.jit(JM.commit_verify, static_argnames=("cfg", "page_size"))
_jdecode = jax.jit(JM.decode_step, static_argnames=("cfg", "page_size"))
_jaccept = jax.jit(JSP.accept_tree, static_argnames=("topo", "vocab"))


def _cfgs(variant):
    arch, kw, _ = VARIANTS[variant]
    return (dataclasses.replace(jax_smoke_config(arch), **kw),
            dataclasses.replace(smoke_config(arch), **kw))


_REFS = {}


def _ref(variant):
    """JAX's results for one variant, computed once: a per-slot cache after
    some decode steps (7 under the window, so its buffer has rolled), then
    on it ``verify_tree`` at full depth, the three ``draft_tree_level``
    passes at exit depth 1, and ``commit_verify`` along PATH / N_ACC; with
    their inputs, as numpy."""
    if variant in _REFS:
        return _REFS[variant]
    jcfg, _ = _cfgs(variant)
    paged = VARIANTS[variant][2]
    jp = jax.device_get(JM.init_params(jax.random.PRNGKey(0), jcfg))
    ja = jax_elastic.active_widths_batch(jcfg, [0.5, 1.0])
    rng = np.random.default_rng(3)
    kw = {}
    if paged:
        layout = JP.PagedLayout(page_size=PS)
        table = rng.permutation(layout.pool_pages(jcfg, 2, 16))[
            :2 * (16 // PS)].reshape(2, 16 // PS).astype(np.int32)
        jc = JP.init_paged_cache(jcfg, 2, 16, layout)
        jc["pos"] = jnp.asarray([1, 4], jnp.int32)
        kw = dict(pages=jnp.asarray(table), page_size=PS)
    else:
        table = None
        jc = JM.init_decode_cache(jcfg, 2, 16, per_slot=True)
    for t in range(7 if jcfg.sliding_window else 3):
        _, jc = _jdecode(jp, jc, jnp.asarray([[3 + t], [5 + t]], jnp.int32),
                         cfg=jcfg, active=ja, **kw)
    topo = JSP.tree_topology(TREE)
    toks = rng.integers(1, jcfg.vocab_size, (2, topo.n_nodes))
    logits, pend = _jverify(jp, jc, jnp.asarray(toks, jnp.int32), cfg=jcfg,
                            tree=topo, active=ja, **kw)
    carry = JM.init_tree_draft_carry(jcfg, 2, topo, depth=1)
    levels = []
    for level in range(topo.n_levels):
        f0, f1 = topo.level_nodes(level)
        lg, carry = _jlevel(jp, jc, carry, jnp.asarray(toks[:, f0:f1],
                                                       jnp.int32),
                            cfg=jcfg, tree=topo, level=level, depth=1,
                            active=ja, **kw)
        levels.append(np.asarray(lg))
    committed = _jcommit(jc, pend, jnp.asarray(N_ACC), cfg=jcfg,
                         path_nodes=jnp.asarray(PATH), **kw)
    _REFS[variant] = dict(
        params=jp, cache=jax.device_get(jc), toks=toks, table=table,
        logits=np.asarray(logits), pending=jax.device_get(pend),
        levels=levels, committed=jax.device_get(committed))
    return _REFS[variant]


def _port(variant):
    """(params, cache, active, paging kwargs) of the port for a variant,
    from the JAX reference's inputs."""
    r = _ref(variant)
    _, tcfg = _cfgs(variant)
    kw = ({} if r["table"] is None else
          dict(pages=torch.from_numpy(r["table"]), page_size=PS))
    return (params_from_jax(r["params"], device="cpu"),
            cache_from_jax(r["cache"], device="cpu"),
            elastic.active_widths_batch(tcfg, [0.5, 1.0], device="cpu"), kw)


# ---------------------------------------------------------------------------
# topology and policy arithmetic
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("branching", TOPOLOGIES,
                         ids=["x".join(map(str, b)) for b in TOPOLOGIES])
def test_topology_arrays_and_counts_match_jax(branching):
    jt, tt = JSP.tree_topology(branching), TSP.tree_topology(branching)
    assert TSP.tree_topology(branching) is tt  # memoized
    assert (tt.n_nodes, tt.n_levels, tt.n_draft_nodes) == \
        (jt.n_nodes, jt.n_levels, jt.n_draft_nodes)
    for name in ("parents", "depths", "children", "ancestor_bias"):
        np.testing.assert_array_equal(getattr(tt, name), getattr(jt, name),
                                      err_msg=name)
    assert tt.paths == jt.paths
    for level in range(tt.n_levels + 1):
        assert tt.level_nodes(level) == jt.level_nodes(level)
    assert TM.tree_carry_nodes(tt) == JM.tree_carry_nodes(jt)
    assert TSP.tree_draft_position_count(branching) == \
        JSP.tree_draft_position_count(branching)
    assert TSP.tree_rescore_position_count(branching) == \
        JSP.tree_rescore_position_count(branching)
    assert TSP.tree_node_budget(branching) == JSP.tree_node_budget(branching)
    assert TSP.tree_draft_compile_key(1, branching) == \
        JSP.tree_draft_compile_key(1, branching)
    assert TSP.tree_verify_compile_key(3, branching) == \
        JSP.tree_verify_compile_key(3, branching)


def test_policy_arithmetic_and_plan_match_jax():
    with pytest.raises(ValueError, match="branching"):
        TSP.TreeTopology((2, 0))
    for a in (0.0, 0.05, 0.35, 0.9, 1.0):
        for br in TOPOLOGIES + [(1, 1, 1)]:
            assert TSP.expected_tokens_per_tree_launch(a, br) == \
                pytest.approx(JSP.expected_tokens_per_tree_launch(a, br),
                              abs=1e-12)
            for s in (a, 1.0 - a, -0.1):
                assert TSP.per_candidate_accept_rate(s, br) == \
                    pytest.approx(JSP.per_candidate_accept_rate(s, br),
                                  abs=1e-12)
        assert TSP.per_candidate_accept_rate(a, None) == \
            JSP.per_candidate_accept_rate(a, None)
    for kw in (dict(ks=(), trees=((2, 1), (2, 2))),
               dict(ks=(2, 4), trees=((3, 2, 1),), draft_depth=1),
               dict(ks=(3,))):
        tp = TSP.spec_plan([1, 3, 3, 2], TSP.SpecConfig(**kw))
        jp = JSP.spec_plan([1, 3, 3, 2], JSP.SpecConfig(**kw))
        assert {d: (e.depth, e.draft_depth, e.ks, e.trees)
                for d, e in tp.items()} == \
            {d: (e.depth, e.draft_depth, e.ks, e.trees)
             for d, e in jp.items()}
    tel = TSP.SpecTelemetry(k=3, tree=(2, 2, 1), nodes=10)
    tel.record([1, 3], 2, 0.5)
    assert tel.summary()["tree"] == "2x2x1"
    assert tel.summary()["draft_nodes"] == 10


# ---------------------------------------------------------------------------
# the acceptance rule
# ---------------------------------------------------------------------------


def test_accept_tree_greedy_reduction():
    """The JAX test's case: at temperature 0 the walk takes the child equal
    to the verifier's argmax at any sibling rank and emits the argmax."""
    topo = TSP.tree_topology((2, 1))
    tokens = torch.tensor([[0, 4, 6, 2, 7], [0, 4, 6, 2, 7]])
    logits = torch.full((2, 5, 8), -5.0)
    for node, per_slot in {0: [6, 5], 2: [7, 0], 4: [3, 0]}.items():
        for b in range(2):
            logits[b, node, per_slot[b]] = 5.0
    dlogits = torch.full((2, 5, 8), -5.0)
    dlogits[:, 0, 4] = 5.0
    dlogits[:, 2, 7] = 5.0
    out, path, n_acc = TSP.accept_tree(logits, dlogits, tokens, topo,
                                       TSA.make_slot_keys(0, 2), 0.0, 8)
    assert n_acc.tolist() == [2, 0]
    assert out[0].tolist() == [6, 7, 3] and int(out[1, 0]) == 5
    assert path[0].tolist() == [0, 2, 4] and path[1, :2].tolist() == [0, 0]


@pytest.mark.parametrize("branching", [(2, 2, 1), (3, 2, 1)],
                         ids=["2x2x1", "3x2x1"])
def test_accept_tree_greedy_matches_jax(branching):
    """Greedy children (the draft's top-b) and verifier logits that agree
    with the draft at some nodes and pick a lower-ranked sibling at others:
    the port's tokens, paths and counts equal JAX's. Every row's top b + 1
    logits are distinct (continuous draws)."""
    topo = TSP.tree_topology(branching)
    jtopo = JSP.tree_topology(branching)
    B, V, Vp = 16, 24, 32
    rng = np.random.default_rng(11)
    dl = rng.standard_normal((B, topo.n_nodes, Vp)).astype(np.float32)
    tokens = np.zeros((B, topo.n_nodes), np.int64)
    for level, b in enumerate(branching):
        f0, f1 = topo.level_nodes(level)
        for node in range(f0, f1):
            top = np.argsort(-dl[:, node, :V], axis=-1)[:, :b]
            tokens[:, topo.children[node, :b]] = top
    vl = dl + 0.8 * rng.standard_normal(dl.shape).astype(np.float32)
    out, path, n_acc = TSP.accept_tree(
        torch.from_numpy(vl), torch.from_numpy(dl), torch.from_numpy(tokens),
        topo, TSA.make_slot_keys(0, B), 0.0, V)
    jo, jpath, jn = _jaccept(
        jnp.asarray(vl), jnp.asarray(dl), jnp.asarray(tokens, jnp.int32),
        jtopo, JSA.make_slot_keys(0, B), 0.0, V)
    np.testing.assert_array_equal(n_acc.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(path.numpy(), np.asarray(jpath))
    np.testing.assert_array_equal(out.numpy(), np.asarray(jo))
    assert len(set(n_acc.tolist())) > 1  # several acceptance depths


def test_accept_tree_sampled_tracks_the_verifier():
    """With sibling candidates drawn i.i.d. from q, the first emitted token
    is distributed as the verifier p (multi-candidate rejection sampling):
    total variation below 0.05 over 8192 slots at temperature 1."""
    V, b, n = 8, 3, 8192
    topo = TSP.tree_topology((b,))
    rng = np.random.default_rng(7)
    p = rng.dirichlet(np.ones(V) * 2.0)
    q = rng.dirichlet(np.ones(V) * 2.0)
    logits = torch.from_numpy(np.log(p).astype(np.float32)).expand(n, 1 + b, V)
    dlogits = torch.from_numpy(np.log(q).astype(np.float32)).expand(n, 1 + b, V)
    draws = rng.choice(V, size=(n, b), p=q)
    tokens = torch.from_numpy(np.concatenate(
        [np.zeros((n, 1), np.int64), draws], axis=1))
    out, _, _ = TSP.accept_tree(logits, dlogits, tokens, topo,
                                TSA.make_slot_keys(3, n), 1.0, V)
    emp = np.bincount(out[:, 0].numpy(), minlength=V) / n
    tv = 0.5 * np.abs(emp - p).sum()
    assert tv < 0.05, (tv, emp, p)


def test_sampled_tree_draft_children_draw_their_own_streams():
    """At temperature > 0 the draft's batched draw of a level's children
    equals one ``sample_tokens(..., salt=c)`` per child c (the reference's
    per-child loop), so siblings draw from distinct keys: over 8 slots and
    the 3 sibling pairs of a (2, 2, 1) tree, siblings differ but in at
    most two of 24."""
    _, tcfg = _cfgs("full")
    tp = TM.init_params(tcfg, seed=2, device="cpu")
    cache = TM.init_decode_cache(tcfg, 8, 16, per_slot=True, device="cpu")
    topo = TSP.tree_topology(TREE)
    draft = TSP.make_tree_draft_step(tcfg, 1, TREE)
    keys = TSA.make_slot_keys(4, 8)
    tok0 = torch.arange(1, 9)[:, None]
    tokens, dlg = draft(tp, cache, tok0, None, keys, 1.5, 9)
    kd = TSA.fold_in(TSA.fold_step(keys, 9), TSP._STREAM_DRAFT)
    for node in range(TM.tree_carry_nodes(topo)):
        for c in topo.children[node, :topo.branching[topo.depths[node]]]:
            want = TSA.sample_tokens(dlg[:, node], kd, 1.5, tcfg.vocab_size,
                                     salt=int(c))
            assert torch.equal(tokens[:, c], want), (node, c)
    pairs = [(int(a), int(b)) for a, b in topo.children[:3, :2]]
    same = sum(int((tokens[:, a] == tokens[:, b]).sum()) for a, b in pairs)
    assert same <= 2, same
    assert not torch.equal(tokens, draft(tp, cache, tok0, None, keys, 1.5,
                                         10)[0])


# ---------------------------------------------------------------------------
# verify, draft and commit against JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_verify_tree_matches_jax(variant):
    """Logits and per-node candidates at full depth, unfused and fused (the
    fused CPU path is ``fused_verify_plain``); the cache is read only."""
    r = _ref(variant)
    _, tcfg = _cfgs(variant)
    tp, tc, ta, kw = _port(variant)
    before = to_numpy(tc)
    topo = TSP.tree_topology(TREE)
    for fused in ((False, True) if tcfg.family != "ssm" else (False,)):
        logits, pend = TM.verify_tree(tp, tc, torch.from_numpy(r["toks"]),
                                      tcfg, tree=topo, active=ta,
                                      fused=fused, **kw)
        np.testing.assert_allclose(logits.numpy(), r["logits"], atol=ATOL,
                                   rtol=0, err_msg=f"fused={fused} logits")
        for pn, layer in r["pending"]["stack"].items():
            for k, a in layer.items():
                np.testing.assert_allclose(
                    pend["stack"][pn][k].numpy(), np.asarray(a), atol=ATOL,
                    rtol=0, err_msg=f"fused={fused} pending {pn}/{k}")
    after = to_numpy(tc)
    for pn in before["stack"]:
        for k in before["stack"][pn]:
            np.testing.assert_array_equal(after["stack"][pn][k],
                                          before["stack"][pn][k])


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_draft_levels_and_commit_match_jax(variant):
    """``draft_tree_level`` chained over the three levels at exit depth 1
    (logits per level), and ``commit_verify(path_nodes=)`` of the full-depth
    verify along PATH with N_ACC (positions exactly; leaves at atol 1e-4,
    int8 values within one step of the absmax rounding)."""
    r = _ref(variant)
    _, tcfg = _cfgs(variant)
    tp, tc, ta, kw = _port(variant)
    topo = TSP.tree_topology(TREE)
    carry = TM.init_tree_draft_carry(tcfg, 2, topo, depth=1, device="cpu")
    for level in range(topo.n_levels):
        f0, f1 = topo.level_nodes(level)
        lg, carry = TM.draft_tree_level(
            tp, tc, carry, torch.from_numpy(r["toks"][:, f0:f1]), tcfg,
            tree=topo, level=level, depth=1, active=ta, **kw)
        np.testing.assert_allclose(lg.numpy(), r["levels"][level], atol=ATOL,
                                   rtol=0, err_msg=f"level {level}")
    _, pend = TM.verify_tree(tp, tc, torch.from_numpy(r["toks"]), tcfg,
                             tree=topo, active=ta, **kw)
    out = TM.commit_verify(tc, pend, torch.from_numpy(N_ACC), tcfg,
                           path_nodes=torch.from_numpy(PATH), **kw)
    assert out is tc
    got, want = to_numpy(tc), r["committed"]
    np.testing.assert_array_equal(got["pos"], np.asarray(want["pos"]))
    for pn, layer in want["stack"].items():
        for k, a in layer.items():
            a = np.asarray(a)
            atol = 1 if a.dtype == np.int8 else ATOL
            np.testing.assert_allclose(got["stack"][pn][k].astype(np.float32),
                                       a.astype(np.float32), atol=atol,
                                       rtol=0, err_msg=f"commit {pn}/{k}")


@pytest.mark.parametrize("variant", ["full", "kv_quant", "mamba2"])
def test_draft_rows_equal_verify_rows_and_cache_is_untouched(variant):
    """In the port: at the draft depth, each level's carried rows equal the
    verify pass's candidates for those nodes bit for bit, and its logits
    equal the verify rows (bit for bit with TinyLlama's untied unembedding;
    see the module docstring for Mamba2's tied one); the committed cache is
    not written by the draft."""
    r = _ref(variant)
    _, tcfg = _cfgs(variant)
    tp, tc, ta, kw = _port(variant)
    before = to_numpy(tc)
    topo = TSP.tree_topology(TREE)
    toks = torch.from_numpy(r["toks"])
    draft = TSP.make_tree_draft_step(tcfg, 1, TREE)
    keys = TSA.make_slot_keys(0, 2)
    tokens, dlg = draft(tp, tc, toks[:, :1], ta, keys, 0.0, 0, **(
        {"pages": kw["pages"]} if kw else {}))
    # the draft's own tree, scored again by verify_tree at the exit depth
    vl, pend = TM.verify_tree(tp, tc, tokens, tcfg, tree=topo, depth=1,
                              active=ta, **kw)
    nc = TM.tree_carry_nodes(topo)
    if tcfg.tie_embeddings:
        np.testing.assert_allclose(dlg[:, :nc].numpy(), vl[:, :nc].numpy(),
                                   atol=1e-6, rtol=0)
    else:
        assert torch.equal(dlg[:, :nc], vl[:, :nc].float())
    assert not dlg[:, nc:].any()  # leaf rows stay zero
    for pn, layer in draft.carry["stack"].items():
        for k, t in layer.items():
            want = pend["stack"][pn][k][:, :, :nc]
            if k in ("k", "v") and tcfg.kv_quant:  # carried round trip
                from repro_torch.models.layers import (dequantize_kv,
                                                       quantize_kv)
                want = dequantize_kv(*quantize_kv(want), t.dtype)
            assert torch.equal(t, want.to(t.dtype)), (pn, k)
    after = to_numpy(tc)
    for pn in before["stack"]:
        for k in before["stack"][pn]:
            np.testing.assert_array_equal(after["stack"][pn][k],
                                          before["stack"][pn][k])
    np.testing.assert_array_equal(after["pos"], before["pos"])


def test_verify_tree_guards():
    _, tcfg = _cfgs("swa")
    tp = TM.init_params(tcfg, seed=0, device="cpu")
    cache = TM.init_decode_cache(tcfg, 1, 8, per_slot=True, device="cpu")
    with pytest.raises(ValueError, match="nodes"):
        TM.verify_tree(tp, cache, torch.zeros((1, 5), dtype=torch.int64),
                       tcfg, tree=TSP.tree_topology((2,)))
    deep = TSP.tree_topology((1, 1, 1, 1, 1))
    with pytest.raises(ValueError, match="sliding"):
        TM.verify_tree(tp, cache, torch.zeros((1, 6), dtype=torch.int64),
                       tcfg, tree=deep)
