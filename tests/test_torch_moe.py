"""The port's MoE layers and MoE models against the JAX package.

Same weights in both packages (JAX init, converted through numpy), f32
smoke configs (4 experts, top-2, d 64; granite and mixtral every layer
MoE, jamba's hybrid period of 7 SSM + 1 attention layers with MoE on
every other one, cut to 2 periods to keep the JAX side quick), inputs from
numpy seeds, atol 1e-4:

* ``apply_moe`` (capacity dispatch over token groups, a capacity overflow
  that drops assignments, the one-group fallback when the token count does
  not divide, the gelu and squared-relu experts) and ``apply_moe_dense``
  (with ``active_topk`` a scalar and per slot, 1 included);
* ``init_params``' MoE layout and init scales;
* ``forward`` (capacity and dense), ``loss_fn``'s ``moe_aux`` and its
  gradients against ``jax.grad``;
* ``prefill``, ``decode_step`` at mixed widths (``active["top_k"]``),
  ``verify_step``, ``commit_verify``, ``verify_tree``,
  ``draft_tree_level`` and the path commit, for granite, mixtral (window
  6) and jamba;
* ``morph_config`` and ``active_widths`` with ``top_k``, and width slicing
  leaving the experts untouched.

Routing is discrete: a token whose k-th and (k+1)-th router probabilities
differ by less than the tolerance could take other experts under a
different summation order. The routing checks compare top-k sets only
where that margin exceeds the tolerance, and every input here is checked
to have no closer margin, so that the outputs compare everywhere.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.core import elastic as jax_elastic
from repro.models import model as JM
from repro.models import moe as JMOE
from repro.runtime import speculative as JSP
from repro_torch.configs import MorphMode, get_config, smoke_config
from repro_torch.convert import cache_from_jax, params_from_jax, to_numpy
from repro_torch.core import elastic
from repro_torch.models import model as TM
from repro_torch.models import moe as TMOE
from repro_torch.runtime import speculative as TSP
from torch_threads import one_thread  # noqa: E402,F401  (autouse)

ATOL = 1e-4
ARCHS = {"granite": ("granite-moe-1b-a400m", {}),
         "mixtral": ("mixtral-8x22b", {"sliding_window": 6}),
         "jamba": ("jamba-v0.1-52b", {"n_layers": 16})}
TREE = (2, 2, 1)
PATH = np.array([[0, 2, 5, 5], [0, 1, 3, 7]], np.int32)
N_ACC = np.array([2, 3], np.int32)


def _cfgs(arch, **extra):
    name, kw = ARCHS[arch]
    kw = dict(kw, **extra)
    return (dataclasses.replace(jax_smoke_config(name), **kw),
            dataclasses.replace(smoke_config(name), **kw))


def _close(got, want, msg):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=ATOL,
                               rtol=0, err_msg=msg)


def _topk_checked(x, router, k, port_idx):
    """Top-k sets of the port against numpy's router, on the tokens whose
    k-th and (k+1)-th probabilities are more than ATOL apart; asserts that
    no token is closer (so the outputs may be compared everywhere)."""
    lg = x.reshape(-1, x.shape[-1]).astype(np.float64) @ router
    p = np.exp(lg - lg.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    srt = np.sort(p, -1)[:, ::-1]
    margin = (srt[:, k - 1] - srt[:, k]) if k < p.shape[-1] else \
        np.full(p.shape[0], np.inf)
    clear = margin > ATOL
    assert clear.all(), f"{int((~clear).sum())} tokens route within ATOL"
    want = np.sort(np.argsort(-p, -1)[:, :k], -1)
    got = np.sort(port_idx.reshape(-1, k).numpy(), -1)
    np.testing.assert_array_equal(got[clear], want[clear])


def _moe_layer(jcfg):
    jp = jax.device_get(JMOE.init_moe(jax.random.PRNGKey(1), jcfg))
    return jp, params_from_jax(jp, device="cpu")


# case -> (config overrides, (B, S))
MOE_CASES = {"groups": ({"moe_group_size": 8}, (2, 12)),
             "overflow": ({"moe_group_size": 8, "capacity_factor": 0.25},
                          (2, 12)),
             "fallback": ({"moe_group_size": 4}, (2, 5)),
             "gelu": ({"activation": "gelu", "moe_group_size": 8}, (2, 12)),
             "squared_relu": ({"activation": "squared_relu",
                               "moe_group_size": 8}, (2, 12))}


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_apply_moe_matches_jax(case):
    """Capacity dispatch: 3 groups of 8 tokens (capacity 8), the same with
    capacity factor 0.25 (capacity 4: assignments drop, so the output
    differs from the dropless one), 10 tokens over groups of 4 (one group
    of 10), and the two non-gated experts; outputs and the aux loss."""
    kw, (B, S) = MOE_CASES[case]
    jcfg, tcfg = _cfgs("granite", **kw)
    jp, tp = _moe_layer(jcfg)
    x = np.random.default_rng(5).standard_normal(
        (B, S, jcfg.d_model)).astype(np.float32)
    jy, ja = JMOE.apply_moe(jp, jnp.asarray(x), jcfg)
    ty, ta = TMOE.apply_moe(tp, torch.from_numpy(x), tcfg)
    _, _, idx = TMOE._route(torch.from_numpy(x), tp["router"], tcfg.top_k)
    _topk_checked(x, np.asarray(jp["router"], np.float64), tcfg.top_k, idx)
    _close(ty.numpy(), jy, f"{case} y")
    _close(float(ta), float(ja), f"{case} aux")
    dropless, _ = TMOE.apply_moe_dense(tp, torch.from_numpy(x), tcfg)
    dropped = not torch.allclose(ty, dropless, atol=ATOL)
    assert dropped == (case == "overflow")


@pytest.mark.parametrize("active", ["none", "scalar1", "per_slot"])
def test_apply_moe_dense_matches_jax(active):
    """The dropless path at top-3 of 4 experts, with no width gate, a
    scalar ``active_topk`` of 1 and per-slot ones (3, 1): outputs and aux."""
    jcfg, tcfg = _cfgs("mixtral", top_k=3)
    jp, tp = _moe_layer(jcfg)
    x = np.random.default_rng(6).standard_normal(
        (2, 3, jcfg.d_model)).astype(np.float32)
    at = {"none": None, "scalar1": 1, "per_slot": [3, 1]}[active]
    jy, ja = JMOE.apply_moe_dense(
        jp, jnp.asarray(x), jcfg,
        active_topk=None if at is None else jnp.asarray(at, jnp.int32))
    ty, ta = TMOE.apply_moe_dense(
        tp, torch.from_numpy(x), tcfg,
        active_topk=None if at is None else torch.tensor(at, dtype=torch.int32))
    _, _, idx = TMOE._route(torch.from_numpy(x), tp["router"], 3)
    _topk_checked(x, np.asarray(jp["router"], np.float64), 3, idx)
    _close(ty.numpy(), jy, f"{active} y")
    _close(float(ta), float(ja), f"{active} aux")
    if active == "per_slot":  # slot 1 at top-1: its single expert, weight 1
        one, _ = TMOE.apply_moe_dense(tp, torch.from_numpy(x[1:]), tcfg,
                                      active_topk=1)
        _close(ty[1:].numpy(), one.numpy(), "per-slot top-1")


_JP = {}


def _jax_params(arch):
    if arch not in _JP:
        jcfg, _ = _cfgs(arch)
        _JP[arch] = jax.device_get(JM.init_params(jax.random.PRNGKey(0), jcfg))
    return _JP[arch]


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_init_params_moe_layout_matches_jax(arch):
    """Same tree, shapes and dtypes as JAX's init, and the same init scales
    (std within 10%) on every leaf of at least 1024 values (fewer, as the
    SSM's per-head ``A_log`` / ``dt_bias``, are too few draws to compare):
    ``norm2`` + ``moe`` on MoE layers, ``norm2`` + ``mlp`` on the others
    (jamba's even positions)."""
    jcfg, tcfg = _cfgs(arch)
    jp = _jax_params(arch)
    tp = TM.init_params(tcfg, seed=0, device="cpu")

    def walk(a, b, path=""):
        assert set(a) == set(b), path
        for k in a:
            if isinstance(a[k], dict):
                walk(a[k], b[k], f"{path}/{k}")
            else:
                assert tuple(b[k].shape) == np.shape(a[k]), f"{path}/{k}"
                assert str(b[k].dtype).endswith(str(np.asarray(a[k]).dtype))
                if b[k].numel() < 1024:
                    continue
                sa, sb = float(np.std(a[k])), float(b[k].float().std())
                assert abs(sa - sb) <= 0.1 * max(sa, 1e-6) + 1e-6, f"{path}/{k}"

    walk(jp, tp)
    for p in range(tcfg.period):
        layer = tp["stack"][f"pos{p}"]
        assert ("moe" in layer) == tcfg.layer_is_moe(p)
        assert ("mlp" in layer) == (not tcfg.layer_is_moe(p))
        assert "norm2" in layer


def _batch(cfg, B=2, S=12, seed=7):
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    return toks[:, :-1], toks[:, 1:]


@functools.partial(jax.jit, static_argnames=("cfg",))
def _jforward_loss(params, batch, cfg):
    fwd = JM.forward(params, {"tokens": batch["tokens"]}, cfg,
                     collect_exits=cfg.elastic.exit_layers)
    return fwd, JM.loss_fn(params, batch, cfg)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_forward_and_loss_match_jax(arch):
    """``forward`` logits (with an exit) and aux under capacity dispatch
    (24 tokens in one group), for granite also under
    ``moe_impl="dense"`` (the dropless layer is held for every family by
    the decode tests); ``loss_fn``'s loss, ce and ``moe_aux``."""
    jp = _jax_params(arch)
    tp = params_from_jax(jp, device="cpu")
    for impl in ("capacity", "dense") if arch == "granite" else ("capacity",):
        jcfg, tcfg = _cfgs(arch, moe_impl=impl)
        toks, tgts = _batch(jcfg)
        exits = jcfg.elastic.exit_layers
        (jo, ja), (jl, jm) = _jforward_loss(
            jp, {"tokens": jnp.asarray(toks), "targets": jnp.asarray(tgts)},
            cfg=jcfg)
        to, ta = TM.forward(tp, {"tokens": torch.from_numpy(toks).long()},
                            tcfg, collect_exits=exits)
        assert set(to) == set(jo)
        for k in jo:
            _close(to[k].detach().numpy(), jo[k], f"{impl} {k}")
        _close(float(ta), float(ja), f"{impl} aux")
        assert float(ta) > 0
        tl, tm = TM.loss_fn(tp, {"tokens": torch.from_numpy(toks).long(),
                                 "targets": torch.from_numpy(tgts).long()},
                            tcfg)
        _close(float(tl), float(jl), f"{impl} loss")
        _close(float(tm["moe_aux"]), float(jm["moe_aux"]), f"{impl} moe_aux")
        _close(float(tm["ce"]), float(jm["ce"]), f"{impl} ce")


def test_loss_grads_match_jax_granite():
    """``loss_fn`` gradients (ce + 0.01 aux, through the router, the kept
    gates and the experts) of granite smoke against ``jax.grad``: every
    leaf at atol 1e-4."""
    from repro_torch.optim import grads_of, trainable

    jcfg, tcfg = _cfgs("granite")
    jp = _jax_params("granite")
    toks, tgts = _batch(jcfg)
    jg = jax.device_get(jax.grad(lambda p: JM.loss_fn(
        p, {"tokens": jnp.asarray(toks), "targets": jnp.asarray(tgts)},
        jcfg)[0])(jax.tree_util.tree_map(jnp.asarray, jp)))
    tp = trainable(params_from_jax(jp, device="cpu"))
    loss, _ = TM.loss_fn(tp, {"tokens": torch.from_numpy(toks).long(),
                              "targets": torch.from_numpy(tgts).long()}, tcfg)
    tg = to_numpy(grads_of(loss, tp))

    def walk(a, b, path=""):
        for k in a:
            if isinstance(a[k], dict):
                walk(a[k], b[k], f"{path}/{k}")
            else:
                _close(b[k], a[k], f"grad {path}/{k}")

    walk(jg, tg)
    assert np.abs(tg["stack"]["pos0"]["moe"]["router"]).max() > 0


_jdecode = jax.jit(JM.decode_step, static_argnames=("cfg", "depth"))
_jverify = jax.jit(JM.verify_step, static_argnames=("cfg", "depth"))
_jcommit = jax.jit(JM.commit_verify, static_argnames=("cfg",))
_jtree = jax.jit(JM.verify_tree, static_argnames=("cfg", "tree", "depth"))
_jlevel = jax.jit(JM.draft_tree_level, static_argnames=("cfg", "tree",
                                                        "level", "depth"))
_REFS = {}


def _ref(arch):
    """JAX's serving-path results for one arch, computed once: a 7-token
    prompt prefilled into slot 1 of 2 (capacity dispatch), slot 0 fed by
    decode steps at mixed widths (past the window of 6 for mixtral), then
    on that cache a K = 3 ``verify_step`` and its ``commit_verify``, and a
    (2, 2, 1) ``verify_tree``, the three ``draft_tree_level`` passes at exit
    depth 1 and the path commit."""
    if arch in _REFS:
        return _REFS[arch]
    jcfg, _ = _cfgs(arch)
    jp = _jax_params(arch)
    ja = jax_elastic.active_widths_batch(jcfg, [0.5, 1.0])
    rng = np.random.default_rng(3)
    prompt = rng.integers(1, jcfg.vocab_size, (1, 7)).astype(np.int32)
    plog, jc = jax.jit(JM.prefill, static_argnames=(
        "cfg", "cache_extra", "per_slot", "slot", "n_slots"))(
        jp, {"tokens": jnp.asarray(prompt)}, cfg=jcfg, cache_extra=9,
        per_slot=True, slot=1, n_slots=2)
    toks = rng.integers(1, jcfg.vocab_size, (8, 2, 1)).astype(np.int32)
    dlog = []
    for t in toks:
        lg, jc = _jdecode(jp, jc, jnp.asarray(t), cfg=jcfg, active=ja)
        dlog.append(np.asarray(lg))
    cache = jax.device_get(jc)
    vt = rng.integers(1, jcfg.vocab_size, (2, 4)).astype(np.int32)
    vlog, pend = _jverify(jp, jc, jnp.asarray(vt), cfg=jcfg, active=ja)
    n_acc = np.array([1, 3], np.int32)
    committed = jax.device_get(_jcommit(jc, pend, jnp.asarray(n_acc),
                                        cfg=jcfg))
    topo = JSP.tree_topology(TREE)
    tt = rng.integers(1, jcfg.vocab_size, (2, topo.n_nodes)).astype(np.int32)
    tlog, tpend = _jtree(jp, jc, jnp.asarray(tt), cfg=jcfg, tree=topo,
                         active=ja)
    carry = JM.init_tree_draft_carry(jcfg, 2, topo, depth=1)
    levels = []
    for level in range(topo.n_levels):
        f0, f1 = topo.level_nodes(level)
        lg, carry = _jlevel(jp, jc, carry, jnp.asarray(tt[:, f0:f1]),
                            cfg=jcfg, tree=topo, level=level, depth=1,
                            active=ja)
        levels.append(np.asarray(lg))
    tcommit = jax.device_get(_jcommit(jc, tpend, jnp.asarray(N_ACC),
                                      cfg=jcfg, path_nodes=jnp.asarray(PATH)))
    _REFS[arch] = dict(
        prompt=prompt, plog=np.asarray(plog), toks=toks, dlog=dlog,
        cache=cache, vt=vt, vlog=np.asarray(vlog),
        pend=jax.device_get(pend), n_acc=n_acc, committed=committed, tt=tt,
        tlog=np.asarray(tlog), tpend=jax.device_get(tpend), levels=levels,
        tcommit=tcommit)
    return _REFS[arch]


def _cache_close(got, want, msg):
    got = to_numpy(got)
    np.testing.assert_array_equal(got["pos"], np.asarray(want["pos"]))
    for pn, layer in want["stack"].items():
        for k, a in layer.items():
            _close(got["stack"][pn][k], a, f"{msg} {pn}/{k}")


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_prefill_decode_verify_commit_match_jax(arch):
    """The slot prefill's logits, then decode logits at widths (0.5, 1.0)
    (top-1 and top-2 of the router), the cache they leave, the verify's
    logits and candidates, and the commit."""
    r = _ref(arch)
    _, tcfg = _cfgs(arch)
    tp = params_from_jax(_jax_params(arch), device="cpu")
    ta = elastic.active_widths_batch(tcfg, [0.5, 1.0], device="cpu")
    assert ta["top_k"].tolist() == [1, 2]
    plog, tc = TM.prefill(tp, {"tokens": torch.from_numpy(r["prompt"]).long()},
                          tcfg, cache_extra=9, per_slot=True, slot=1,
                          n_slots=2)
    _close(plog.numpy(), r["plog"], "prefill logits")
    for i, t in enumerate(r["toks"]):
        lg, tc = TM.decode_step(tp, tc, torch.from_numpy(t).long(), tcfg,
                                active=ta)
        _close(lg.numpy(), r["dlog"][i], f"decode {i}")
    _cache_close(tc, r["cache"], "decode cache")
    vlog, pend = TM.verify_step(tp, tc, torch.from_numpy(r["vt"]).long(),
                                tcfg, active=ta)
    _close(vlog.numpy(), r["vlog"], "verify logits")
    for pn, layer in r["pend"]["stack"].items():
        for k, a in layer.items():
            _close(pend["stack"][pn][k].numpy(), a, f"pending {pn}/{k}")
    TM.commit_verify(tc, pend, torch.from_numpy(r["n_acc"]), tcfg)
    _cache_close(tc, r["committed"], "commit")


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_tree_verify_draft_and_commit_match_jax(arch):
    """``verify_tree`` (unfused, and fused where the arch has attention
    layers), ``draft_tree_level`` chained at exit depth 1 and
    ``commit_verify(path_nodes=)`` on the decoded cache of
    ``test_prefill_decode_verify_commit_match_jax``."""
    r = _ref(arch)
    _, tcfg = _cfgs(arch)
    tp = params_from_jax(_jax_params(arch), device="cpu")
    ta = elastic.active_widths_batch(tcfg, [0.5, 1.0], device="cpu")
    topo = TSP.tree_topology(TREE)
    tt = torch.from_numpy(r["tt"]).long()
    for fused in (False, True):
        tc = cache_from_jax(r["cache"], device="cpu")
        lg, pend = TM.verify_tree(tp, tc, tt, tcfg, tree=topo, active=ta,
                                  fused=fused)
        _close(lg.numpy(), r["tlog"], f"fused={fused} tree logits")
        for pn, layer in r["tpend"]["stack"].items():
            for k, a in layer.items():
                _close(pend["stack"][pn][k].numpy(), a,
                       f"fused={fused} tree pending {pn}/{k}")
    carry = TM.init_tree_draft_carry(tcfg, 2, topo, depth=1, device="cpu")
    for level in range(topo.n_levels):
        f0, f1 = topo.level_nodes(level)
        lg, carry = TM.draft_tree_level(tp, tc, carry, tt[:, f0:f1], tcfg,
                                        tree=topo, level=level, depth=1,
                                        active=ta)
        _close(lg.numpy(), r["levels"][level], f"level {level}")
    TM.commit_verify(tc, pend, torch.from_numpy(N_ACC), tcfg,
                     path_nodes=torch.from_numpy(PATH))
    _cache_close(tc, r["tcommit"], "path commit")


def test_morph_config_and_active_widths_match_jax():
    """``morph_config``'s reduced top-k (max(1, round(k * w))) and
    ``active_widths`` / ``active_widths_batch``'s ``top_k`` equal JAX's for
    the three families at full size and smoke size; slicing a width-0.5
    subnet leaves every expert tensor and router as it is (the same
    storage, the full shape)."""
    from repro.configs import get_config as jax_get_config

    for name, _ in ARCHS.values():
        for jcfg, tcfg in ((jax_get_config(name), get_config(name)),
                           (jax_smoke_config(name), smoke_config(name))):
            for w in jcfg.elastic.width_fractions:
                mode = MorphMode(depth=tcfg.n_groups, width=w)
                jm = jax_elastic.morph_config(jcfg, mode)
                tm = elastic.morph_config(tcfg, mode)
                assert tm.top_k == jm.top_k == max(1, round(jcfg.top_k * w))
                assert elastic.active_widths(tcfg, w) == \
                    jax_elastic.active_widths(jcfg, w)
            got = elastic.active_widths_batch(
                tcfg, list(jcfg.elastic.width_fractions), device="cpu")
            want = jax_elastic.active_widths_batch(
                jcfg, list(jcfg.elastic.width_fractions))
            assert set(got) == set(want)
            for k in want:
                np.testing.assert_array_equal(got[k].numpy(),
                                              np.asarray(want[k]))
    _, tcfg = _cfgs("jamba")
    tp = TM.init_params(tcfg, device="cpu")
    sub = elastic.slice_params(tp, tcfg, MorphMode(depth=tcfg.n_groups,
                                                   width=0.5))
    for p in range(tcfg.period):
        if tcfg.layer_is_moe(p):
            full, cut = tp["stack"][f"pos{p}"]["moe"], \
                sub["stack"][f"pos{p}"]["moe"]
            for k, t in full.items():
                assert cut[k] is t, k
        else:
            assert sub["stack"][f"pos{p}"]["mlp"]["wi"].shape[-1] == \
                tcfg.d_ff // 2
