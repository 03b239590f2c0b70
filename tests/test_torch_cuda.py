"""The port's CUDA kernels against their plain versions, on the card.

Marked ``gpu``: on a host without a CUDA card every test here skips (the
decision is made inside the fixture, never at import). This file imports no
JAX, so it also runs on the machine with the card, where JAX is not
installed and ``tests/conftest.py`` cannot load:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_cuda.py

Tolerances: f32 inputs agree to 1e-4 (summation order only); bf16 outputs
to one bf16 rounding step (rtol 2^-7) plus atol 1e-3; int8 cache values
exactly. The morph_matmul shapes with 9, 15, 40, 64 and 80 rows (B*M) are
the verify pass's and larger: several n8 row tiles of the tensor-core
kernel, the last one partial; bf16 x takes the tensor-core route, f32 x
the f32 FMA route.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.kernels import fused_decode as FD
from repro_torch.kernels import morph_matmul as MM

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _close(got, want, dtype):
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    else:
        torch.testing.assert_close(got.float(), want.float(), atol=1e-3,
                                   rtol=2.0 ** -7)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(3, 1, 64, 96), (3, 5, 70, 45),
                                   (16, 1, 600, 2051), (2, 3, 4097, 40),
                                   (3, 3, 600, 2051), (8, 5, 2048, 256),
                                   (8, 5, 2048, 5632, "model"),
                                   (8, 8, 2048, 2048, "model"),
                                   (16, 5, 5632, 2048, "model")])
def test_morph_matmul_kernel_matches_plain(cuda, dtype, shape):
    """Shapes marked "model" take the model's weight scale 1 / sqrt(K), so
    that outputs are O(1) as the f32 tolerance assumes (unscaled, at K =
    5632 they reach ~300 and f32 summation order alone moves them by
    2e-4)."""
    B, M, K, N = shape[:4]
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(B, M, K, generator=g, device=cuda).to(dtype)
    w = torch.randn(K, N, generator=g, device=cuda)
    if shape[4:] == ("model",):
        w = w / np.sqrt(K)
    an = torch.randint(0, N + 1, (B,), generator=g, device=cuda,
                       dtype=torch.int32)
    ak = torch.randint(0, K + 1, (B,), generator=g, device=cuda,
                       dtype=torch.int32)
    for a_n, a_k in ((an, ak), (None, ak), (an, None), (None, None)):
        got = MM.morph_matmul(x, w, a_n, a_k)
        want = MM.morph_matmul_plain(x, w, a_n, a_k)
        torch.cuda.synchronize()
        _close(got, want, dtype)
        if a_n is not None:
            dead = torch.arange(N, device=cuda)[None, None, :] >= a_n[:, None, None]
            assert bool((got[dead.expand(B, M, N)] == 0).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_morph_matmul_kernel_is_deterministic(cuda, dtype):
    """Launches on the same inputs are bit-identical: the split-K partials
    are added in split order through the cluster's shared memory."""
    B, M, K, N = 8, 5, 2048, 2048
    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(B, M, K, generator=g, device=cuda).to(dtype)
    w = torch.randn(K, N, generator=g, device=cuda)
    an = torch.randint(1, N + 1, (B,), generator=g, device=cuda,
                       dtype=torch.int32)
    ak = torch.randint(1, K + 1, (B,), generator=g, device=cuda,
                       dtype=torch.int32)
    # the split-K merge runs
    assert MM.plan([N], K, B * M, dtype, w.dtype, dtype == torch.bfloat16,
                   cuda)[0] > 1
    first = MM.morph_matmul(x, w, an, ak)
    for _ in range(3):
        assert torch.equal(MM.morph_matmul(x, w, an, ak), first)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_morph_matmul_dead_tiles_are_zero(cuda, dtype):
    """Column tiles at or past every slot's active_n read no weights and
    come out all zeros (the output is allocated uninitialized), the live
    tile matches the plain version."""
    B, M, K, N = 3, 5, 300, 300
    g = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn(B, M, K, generator=g, device=cuda).to(dtype)
    w = torch.randn(K, N, generator=g, device=cuda)
    an = torch.tensor([10, 64, 3], dtype=torch.int32, device=cuda)
    for _ in range(2):
        got = MM.morph_matmul(x, w, an)
        torch.cuda.synchronize()
        assert not bool(got[:, :, 64:].any())
        _close(got, MM.morph_matmul_plain(x, w, an), dtype)


@pytest.mark.parametrize("variant", ["full", "swa", "kv_quant", "bf16",
                                     "swa_bf16", "swa_int8", "bf16_norope",
                                     "bf16_granite", "int8_granite"])
def test_fused_decode_kernels_match_plain(cuda, variant):
    """The smoke config (hd 16) with f32 caches on the FMA route and bf16 /
    int8 caches on the tensor-core route, with and without a sliding window
    (the slot wraps at position S + 70), and without RoPE (jamba's
    attention layers). The "_granite" variants take granite-moe-1b-a400m's
    attention heads: 16 query heads of 64 over 8 KV heads (group 2), at
    widths (0.5, 1, 1)."""
    cfg = _variant_cfg(variant)
    dt = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    g = torch.Generator(device=cuda).manual_seed(1)
    dm, H, KV, hd, B = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, 3
    params = {n: torch.randn(*s, generator=g, device=cuda) / np.sqrt(s[0])
              for n, s in (("wq", (dm, H * hd)), ("wk", (dm, KV * hd)),
                           ("wv", (dm, KV * hd)), ("wo", (H * hd, dm)))}
    S = cfg.sliding_window or 130
    shape = (B, S, KV, hd)
    if cfg.kv_quant:
        cache = {"k": torch.randint(-127, 128, shape, generator=g, device=cuda,
                                    dtype=torch.int8),
                 "v": torch.randint(-127, 128, shape, generator=g, device=cuda,
                                    dtype=torch.int8),
                 "k_scale": torch.rand(shape[:-1] + (1,), generator=g,
                                       device=cuda).to(torch.bfloat16) / 50,
                 "v_scale": torch.rand(shape[:-1] + (1,), generator=g,
                                       device=cuda).to(torch.bfloat16) / 50}
    else:
        cache = {"k": torch.randn(shape, generator=g, device=cuda).to(dt),
                 "v": torch.randn(shape, generator=g, device=cuda).to(dt)}
    x = torch.randn(B, 1, dm, generator=g, device=cuda).to(dt)
    pos = torch.tensor([0, 4, S + 70], dtype=torch.int32, device=cuda)
    act = _variant_act(cuda, variant, cfg,
                       ([32, 64, 24], [16, 32, 24]))
    c_k = {n: t.clone() for n, t in cache.items()}
    c_p = {n: t.clone() for n, t in cache.items()}
    route = "fma" if cache["k"].dtype == torch.float32 else "tc"
    r0 = FD.route_counts()
    o_k, _ = FD.fused_decode_step(params, x, c_k, pos, cfg, active=act)
    assert FD.route_counts()[route] == r0[route] + 1
    o_p, _ = FD.fused_decode_plain(params, x, c_p, pos, cfg, act["q_dim"],
                                   act["kv_dim"])
    torch.cuda.synchronize()
    _close(o_k, o_p, dt)
    for n in cache:
        if cache[n].dtype == torch.int8:
            assert torch.equal(c_k[n], c_p[n]), n
        else:
            _close(c_k[n], c_p[n], cache[n].dtype)


def test_engine_on_card_fused_equals_unfused(cuda):
    from repro_torch.models.model import init_params
    from repro_torch.runtime.serving import ServingEngine, poisson_trace

    cfg = smoke_config("tinyllama-1.1b")
    params = init_params(cfg, seed=0, device=cuda)
    streams = []
    for fused in (False, True):
        eng = ServingEngine(params, cfg, batch_size=3, cache_capacity=24,
                            prefill_threshold=3, fused=fused, device=cuda)
        eng.warmup()
        trace = poisson_trace(6, 100.0, seed=2, prompt_len=(1, 6),
                              new_tokens=(3, 9), vocab=cfg.vocab_size)
        out = eng.run(trace, budget_fn=None, policy=None)
        assert out["completed"] == 6
        streams.append({r.rid: r.generated for r in eng.completed})
    assert streams[0] == streams[1]


# granite-moe-1b-a400m's attention on the smoke width: group 2 at hd 64
_GRANITE_HEADS = {"n_heads": 16, "n_kv_heads": 8, "head_dim": 64}


def _variant_cfg(variant):
    """The fused decode test's config for ``variant``: TinyLlama's smoke
    config with the variant's overrides, or granite's with its full
    attention heads."""
    kw = {"full": {}, "swa": {"sliding_window": 6},
          "kv_quant": {"kv_quant": True}, "bf16": {"dtype": "bfloat16"},
          "swa_bf16": {"sliding_window": 40, "dtype": "bfloat16"},
          "swa_int8": {"sliding_window": 40, "kv_quant": True},
          "bf16_norope": {"dtype": "bfloat16", "use_rope": False},
          "bf16_granite": dict(_GRANITE_HEADS, dtype="bfloat16"),
          "int8_granite": dict(_GRANITE_HEADS, kv_quant=True)}[variant]
    arch = ("granite-moe-1b-a400m" if variant.endswith("granite")
            else "tinyllama-1.1b")
    return dataclasses.replace(smoke_config(arch), **kw)


def _variant_act(cuda, variant, cfg, widths):
    """Per-slot (q_dim, kv_dim) of a fused test: the given ones, or for a
    granite variant the config's own at widths (0.5, 1, 1)."""
    if variant.endswith("granite"):
        from repro_torch.core import elastic

        a = elastic.active_widths_batch(cfg, [0.5, 1.0, 1.0], device=cuda)
        return {"q_dim": a["q_dim"], "kv_dim": a["kv_dim"]}
    q, kv = widths
    return {"q_dim": torch.tensor(q, dtype=torch.int32, device=cuda),
            "kv_dim": torch.tensor(kv, dtype=torch.int32, device=cuda)}


def tree_np(branching):
    """(node depths, additive ancestor mask) of a token tree with the given
    branching per level, BFS order (node 0 the root): 0 where column j is
    an ancestor-or-self of row i, -1e9 elsewhere."""
    parents, depths, frontier = [-1], [0], [0]
    for lvl, b in enumerate(branching):
        nxt = []
        for node in frontier:
            for _ in range(b):
                nxt.append(len(parents))
                parents.append(node)
                depths.append(lvl + 1)
        frontier = nxt
    n = len(parents)
    bias = np.full((n, n), -1e9, np.float32)
    for i in range(n):
        j = i
        while j >= 0:
            bias[i, j] = 0.0
            j = parents[j]
    return np.asarray(depths, np.int32), bias


def _verify_case(cuda, variant, seed=4):
    """A verify layer on the smoke config (hd 16): the variant's config,
    f32 weights, B = 3 slots, a 130-row cache (6 rows under the window) at
    positions 0, 4 and Sc + 70, mixed widths. "_g8" variants take 16 query
    heads over 2 KV heads: G * S = 40 (linear) or 56 ((2, 2) tree) query
    rows per (slot, KV head), three or four m16 row tiles of one block;
    the (2, 2, 1) and (3, 2, 1) trees give 88 and 128 rows, more than one
    block carries, so they split over blocks (head groups). "_granite"
    variants take granite-moe-1b-a400m's 16 query heads of 64 over 8 KV
    heads (group 2) at widths (0.5, 1, 1); "_norope" skips the rotation
    (jamba's attention)."""
    kw = {"linear_f32": {}, "linear_bf16": {"dtype": "bfloat16"},
          "tree_int8": {"kv_quant": True},
          "linear_swa": {"sliding_window": 6},
          "linear_bf16_g8": {"dtype": "bfloat16", "n_heads": 16,
                             "n_kv_heads": 2},
          "tree_int8_g8": {"kv_quant": True, "n_heads": 16, "n_kv_heads": 2},
          "linear_swa_bf16_g8": {"dtype": "bfloat16", "n_heads": 16,
                                 "n_kv_heads": 2, "sliding_window": 70},
          "tree221_bf16_g8": {"dtype": "bfloat16", "n_heads": 16,
                              "n_kv_heads": 2},
          "tree221_int8_g8": {"kv_quant": True, "n_heads": 16,
                              "n_kv_heads": 2},
          "tree321_bf16_g8": {"dtype": "bfloat16", "n_heads": 16,
                              "n_kv_heads": 2},
          "tree321_int8_g8": {"kv_quant": True, "n_heads": 16,
                              "n_kv_heads": 2},
          "linear_bf16_granite": dict(_GRANITE_HEADS, dtype="bfloat16"),
          "tree221_bf16_granite": dict(_GRANITE_HEADS, dtype="bfloat16"),
          "linear_bf16_norope": {"dtype": "bfloat16", "use_rope": False},
          }[variant]
    arch = ("granite-moe-1b-a400m" if variant.endswith("granite")
            else "tinyllama-1.1b")
    cfg = dataclasses.replace(smoke_config(arch), **kw)
    dt = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    g = torch.Generator(device=cuda).manual_seed(seed)
    dm, H, KV, hd, B = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, 3
    params = {n: torch.randn(*s, generator=g, device=cuda) / np.sqrt(s[0])
              for n, s in (("wq", (dm, H * hd)), ("wk", (dm, KV * hd)),
                           ("wv", (dm, KV * hd)), ("wo", (H * hd, dm)))}
    nd = tb = None
    S = 5
    if variant.startswith("tree"):
        nd, tb = tree_np({"tree221": (2, 2, 1), "tree321": (3, 2, 1)}.get(
            variant[:7], (2, 2)))
        S = len(nd)
    Sc = cfg.sliding_window or 130
    shape = (B, Sc, KV, hd)
    if cfg.kv_quant:
        cache = {"k": torch.randint(-127, 128, shape, generator=g, device=cuda,
                                    dtype=torch.int8),
                 "v": torch.randint(-127, 128, shape, generator=g, device=cuda,
                                    dtype=torch.int8),
                 "k_scale": torch.rand(shape[:-1] + (1,), generator=g,
                                       device=cuda).to(torch.bfloat16) / 50,
                 "v_scale": torch.rand(shape[:-1] + (1,), generator=g,
                                       device=cuda).to(torch.bfloat16) / 50}
    else:
        cache = {"k": torch.randn(shape, generator=g, device=cuda).to(dt),
                 "v": torch.randn(shape, generator=g, device=cuda).to(dt)}
    x = torch.randn(B, S, dm, generator=g, device=cuda).to(dt)
    pos = torch.tensor([0, 4, Sc + 70], dtype=torch.int32, device=cuda)
    act = _variant_act(cuda, variant, cfg, ([32, H * hd, 24], [16, 32, 24]))
    return cfg, dt, params, cache, x, pos, act, nd, tb


@pytest.mark.parametrize("variant", ["linear_f32", "linear_bf16",
                                     "tree_int8", "linear_swa",
                                     "linear_bf16_g8", "tree_int8_g8",
                                     "linear_swa_bf16_g8", "tree221_bf16_g8",
                                     "tree221_int8_g8", "tree321_bf16_g8",
                                     "tree321_int8_g8", "linear_bf16_granite",
                                     "tree221_bf16_granite",
                                     "linear_bf16_norope"])
def test_fused_verify_kernel_matches_plain(cuda, variant):
    """Against the plain version: outputs, raw candidates, the cache left
    as it was, and the route the attention launch reports (bf16 and int8
    caches on the tensor cores, f32 on FMAs). The "_g8" variants carry
    more than 16 query rows per (slot, KV head); under the window of 70
    the rows' lower edges differ inside one block."""
    cfg, dt, params, cache, x, pos, act, nd, tb = _verify_case(cuda, variant)
    before = {n: t.clone() for n, t in cache.items()}
    n0 = FD.verify_launch_count()
    route = "fma" if cache["k"].dtype == torch.float32 else "tc"
    r0 = FD.verify_route_counts()
    o_k, kv_k = FD.fused_verify(params, x, cache, pos, cfg, active=act,
                                node_depth=nd, tree_bias=tb)
    assert FD.verify_launch_count() == n0 + 1
    r1 = FD.verify_route_counts()
    assert r1[route] == r0[route] + 1 and sum(r1.values()) == sum(
        r0.values()) + 1
    o_p, kv_p = FD.fused_verify_plain(params, x, cache, pos, cfg,
                                      act["q_dim"], act["kv_dim"], nd, tb)
    torch.cuda.synchronize()
    _close(o_k, o_p, dt)
    for n in ("k", "v"):
        _close(kv_k[n], kv_p[n], dt)
    for n in cache:  # the cache is read only
        assert torch.equal(cache[n], before[n]), n


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_engine_on_card_greedy_spec_equals_plain(cuda, fused):
    from repro_torch.models.model import init_params
    from repro_torch.runtime.serving import ServingEngine, poisson_trace
    from repro_torch.runtime.speculative import SpecConfig

    cfg = smoke_config("tinyllama-1.1b")
    params = init_params(cfg, seed=0, device=cuda)
    streams = []
    for spec in (None, SpecConfig(ks=(3,), min_accept_rate=0.0)):
        eng = ServingEngine(params, cfg, batch_size=3, cache_capacity=32,
                            prefill_threshold=3, fused=fused,
                            speculative=spec, device=cuda)
        eng.warmup()
        trace = poisson_trace(6, 100.0, seed=2, prompt_len=(1, 6),
                              new_tokens=(3, 12), vocab=cfg.vocab_size)
        out = eng.run(trace, budget_fn=None, policy=None)
        assert out["completed"] == 6
        assert (out["spec_verify_launches"] > 0) == (spec is not None)
        streams.append({r.rid: r.generated for r in eng.completed})
    assert streams[0] == streams[1]


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_engine_on_card_greedy_tree_equals_plain(cuda, fused, paged):
    """Greedy token-tree speculation ((2, 1) and (2, 2, 1) trees, built
    side by side) on the f32 smoke config emits the plain engine's tokens,
    over a dense cache and through a page table, and builds nothing after
    warmup."""
    from repro_torch.models.model import init_params
    from repro_torch.models.paged import PagedLayout
    from repro_torch.runtime.serving import ServingEngine, poisson_trace
    from repro_torch.runtime.speculative import SpecConfig

    cfg = smoke_config("tinyllama-1.1b")
    params = init_params(cfg, seed=0, device=cuda)
    streams = []
    for spec in (None, SpecConfig(ks=(), trees=((2, 1), (2, 2, 1)),
                                  min_accept_rate=0.0)):
        eng = ServingEngine(params, cfg, batch_size=3, cache_capacity=32,
                            prefill_threshold=3, fused=fused,
                            paged=PagedLayout(page_size=4) if paged else None,
                            speculative=spec, device=cuda)
        eng.warmup()
        trace = poisson_trace(6, 100.0, seed=2, prompt_len=(1, 6),
                              new_tokens=(3, 12), vocab=cfg.vocab_size)
        out = eng.run(trace, budget_fn=None, policy=None)
        assert out["completed"] == 6
        assert (out["spec_tree_launches"] > 0) == (spec is not None)
        assert eng.ctrl.stats["compiles"] == eng.compiles_after_warmup
        if paged:
            eng.check_paged_invariants()
        streams.append({r.rid: r.generated for r in eng.completed})
    assert streams[0] == streams[1]


@pytest.mark.parametrize("cache", ["bf16", "int8"])
@pytest.mark.parametrize("branching", [(2, 2, 1), (3, 2, 1)],
                         ids=["2x2x1", "3x2x1"])
def test_paged_tree_verify_full_width(cuda, cache, branching):
    """The verify kernels at TinyLlama's full width with a token tree of 11
    or 16 nodes (88 or 128 query rows per (slot, KV head)), B = 8 over a
    512-row capacity: the paged launch (page 16, shuffled, two slots sharing
    four) against ``fused_verify_plain`` through the same table, on the
    tensor-core route (int8: see the rounding-edge rule below), and
    bit-identical to its dense twin (``plan_len`` = 512); the pool is left
    as it was."""
    cfg, params, dense, pool, table, act, xdt, g = _paged_twin(cuda, cache)
    nd, tb = tree_np(branching)
    ps = 16
    pos = torch.tensor([0, 1, 63, 64, 200, 333, 450, 497], dtype=torch.int32,
                       device=cuda)
    x = torch.randn(8, len(nd), cfg.d_model, generator=g, device=cuda).to(xdt)
    before = {n: t.clone() for n, t in pool.items()}
    r0 = FD.verify_route_counts()
    o_p, kv_p = FD.fused_verify(params, x, pool, pos, cfg, active=act,
                                node_depth=nd, tree_bias=tb, pages=table,
                                page_size=ps, plan_len=512)
    assert FD.verify_route_counts()["tc"] == r0["tc"] + 1
    o_d, kv_d = FD.fused_verify(params, x, dense, pos, cfg, active=act,
                                node_depth=nd, tree_bias=tb)
    o_r, kv_r = FD.fused_verify_plain(params, x, pool, pos, cfg,
                                      act["q_dim"], act["kv_dim"], nd, tb,
                                      pages=table, page_size=ps)
    torch.cuda.synchronize()
    if cache == "int8":
        # the extension attends through the int8 round trip of the new K/V,
        # quantized from f32 projections summed in another order than the
        # plain version's: a value on a rounding edge now and then lands one
        # int8 step apart and moves a few outputs by up to ~1e-2 (the
        # decode's int8 writes may differ by a step, as above); all but
        # 1e-4 of the outputs within one bf16 step + 1e-3, none past 2e-2
        err = (o_p.float() - o_r.float()).abs()
        one_step = 1e-3 + 2.0 ** -7 * o_r.float().abs()
        assert int((err > one_step).sum()) <= 1e-4 * err.numel()
        assert bool((err <= 2e-2 + 2.0 ** -7 * o_r.float().abs()).all())
    else:
        _close(o_p, o_r, xdt)
    for n in ("k", "v"):
        _close(kv_p[n], kv_r[n], xdt)
        assert torch.equal(kv_p[n], kv_d[n]), n
    assert torch.equal(o_p, o_d)
    for n in pool:
        assert torch.equal(pool[n], before[n]), n


def _ssd_inputs(g, shape, dtype):
    """Model-layout scan inputs: x (b, s, h, p), softplus dt, A < 0, B and C
    with G groups."""
    b, s, h, p, G, n = shape
    x = torch.randn(b, s, h, p, generator=g, device="cuda").to(dtype)
    dt = torch.nn.functional.softplus(
        torch.randn(b, s, h, generator=g, device="cuda") - 2.0)
    A = -torch.exp(torch.rand(h, generator=g, device="cuda") * 2.7)
    B = torch.randn(b, s, G, n, generator=g, device="cuda")
    C = torch.randn(b, s, G, n, generator=g, device="cuda")
    return x, dt, A, B, C


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(2, 128, 4, 16, 1, 16),
                                   (1, 100, 6, 24, 2, 128),
                                   (2, 37, 3, 8, 3, 40),
                                   (1, 256, 32, 64, 1, 128),
                                   (1, 1000, 8, 64, 2, 128)])
def test_ssd_scan_kernel_matches_plain(cuda, dtype, shape):
    """The scan kernel against ``ssd_chunked`` (chunk 16) in the model layout
    (B and C per group, a ragged last tile at s = 100, 37 and 1000, hp not a
    multiple of the kernel's 16 columns at 24 and 8; Mamba2-370M's full
    width, and 16 tiles over two groups) and against
    ``ssd_scan_plain`` in the kernel's own layout. f32 y and states agree
    to 1e-3 (the kernel restarts the decay sum every 64 steps, the plain
    version every chunk: rounding only); a bf16 y to one bf16 step."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as SSD
    from repro_torch.kernels.ssd_scan import ssd_chunked

    g = torch.Generator(device=cuda).manual_seed(7)
    x, dt, A, B, C = _ssd_inputs(g, shape, dtype)
    n0 = SSD.launch_count()
    y, st = ops.ssd_scan_bshn(x, dt, A, B, C, chunk=16)
    assert SSD.launch_count() == n0 + 1
    yp, stp = ssd_chunked(x.float(), dt, A, B, C, 16)
    torch.cuda.synchronize()
    assert y.dtype == dtype and y.shape == x.shape
    tol = dict(atol=1e-3, rtol=1e-3) if dtype == torch.float32 else \
        dict(atol=1e-2, rtol=2.0 ** -7)
    torch.testing.assert_close(y.float(), yp.to(dtype).float(), **tol)
    torch.testing.assert_close(st, stp, atol=1e-3, rtol=1e-3)
    # the kernel's own layout: one head per row, B and C repeated
    b, s, h, p, G, n = shape
    rep = h // G
    xf = x.transpose(1, 2).reshape(b * h, s, p).contiguous()
    dtf = dt.transpose(1, 2).reshape(b * h, s).contiguous()
    Af = A.expand(b, h).reshape(b * h).contiguous()
    Bf, Cf = (t.repeat_interleave(rep, dim=2).transpose(1, 2)
              .reshape(b * h, s, n).contiguous() for t in (B, C))
    yk, sk = SSD.ssd_scan(xf, dtf, Af, Bf, Cf, chunk=16)
    yq, sq = SSD.ssd_scan_plain(xf, dtf, Af, Bf, Cf, chunk=16)
    torch.cuda.synchronize()
    torch.testing.assert_close(yk.float(), yq.float(), **tol)
    torch.testing.assert_close(sk, sq, atol=1e-3, rtol=1e-3)


def _bwd_close(name, got, want, dtype):
    """A gradient of the scan's backward kernel against its plain version:
    1e-3 of the gradient's scale plus 1e-3 relative (C.B^T from the
    forward's 3xTF32 products, sums in other orders), a bf16 dx to one
    bf16 step more."""
    got, want = got.float(), want.float()
    assert bool(torch.isfinite(got).all()), name
    scale = float(want.abs().max())
    rtol = 1e-3 + (2.0 ** -7 if name == "dx" and dtype == torch.bfloat16
                   else 0.0)
    torch.testing.assert_close(got, want, atol=1e-3 * max(scale, 1e-6),
                               rtol=rtol, msg=name)


def _scan_grads(cuda, shape, dtype, dt_const=None):
    """Autograd through ``ops.ssd_scan_bshn`` on the card (the forward
    kernel, then the backward kernel on its kept workspace) against
    ``ssd_scan_bwd_plain`` on the same inputs."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as SSD

    g = torch.Generator(device=cuda).manual_seed(11)
    x, dt, A, B, C = _ssd_inputs(g, shape, dtype)
    if dt_const is not None:
        dt = torch.full_like(dt, dt_const)
    leaves = [t.clone().requires_grad_() for t in (x, dt, A, B, C)]
    f0, b0 = SSD.launch_count(), SSD.bwd_launch_count()
    y, st = ops.ssd_scan_bshn(*leaves, chunk=16)
    dy = torch.randn(y.shape, generator=g, device=cuda).to(dtype)
    ds = torch.randn(st.shape, generator=g, device=cuda)
    ((y.float() * dy.float()).sum() + (st * ds).sum()).backward()
    torch.cuda.synchronize()
    assert (SSD.launch_count(), SSD.bwd_launch_count()) == (f0 + 1, b0 + 1)
    b, h = x.shape[0], x.shape[2]
    want = SSD.ssd_scan_bwd_plain(x, dt, A.expand(b, h), B, C, dy, ds)
    want = list(want[:2]) + [want[2].sum(0)] + list(want[3:])
    for name, leaf, w in zip(("dx", "ddt", "dA", "dB", "dC"), leaves, want):
        assert leaf.grad.dtype == leaf.dtype, name
        _bwd_close(name, leaf.grad, w, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(2, 128, 4, 16, 1, 16),
                                   (1, 100, 6, 24, 2, 128),
                                   (2, 37, 3, 8, 3, 40),
                                   (2, 256, 32, 64, 1, 128),
                                   (1, 300, 8, 80, 2, 200)])
def test_ssd_scan_grad_matches_plain_backward(cuda, dtype, shape):
    """Ragged last tiles (100, 37, 300 steps), several groups, hp and n
    off the kernel's 64-column chunks (24, 8, 80; 40, 200) and Mamba2-370M's
    full width at B = 2."""
    _scan_grads(cuda, shape, dtype)


def test_ssd_scan_grad_finite_past_a_tile_decay_of_88(cuda):
    """dt = 0.5 and A in -[1, 15): a 64-step tile decays by up to 480; the
    backward kernel evaluates no positive exponent."""
    _scan_grads(cuda, (1, 256, 8, 16, 1, 16), torch.float32, dt_const=0.5)


def test_mamba2_smoke_grads_on_card_match_cpu(cuda):
    """``loss_fn`` gradients of the mamba2 smoke model (f32) on the card
    (the scan kernels forward and backward) against the CPU route (autograd
    through ``ssd_chunked``): each leaf's relative error norm within 1e-3."""
    from repro_torch.data import DataConfig, make_batch, to_device
    from repro_torch.models.model import init_params, loss_fn
    from repro_torch.optim import grads_of, trainable
    from repro_torch.optim.optimizer import leaves_with_path

    cfg = smoke_config("mamba2-370m")
    p_cpu = init_params(cfg, seed=4, device="cpu")
    batch = make_batch(cfg, DataConfig(seed=1, global_batch=3, seq_len=40), 0)
    grads = []
    for dev in ("cpu", cuda):
        p = trainable(_tree_to(p_cpu, dev))
        loss, _ = loss_fn(p, to_device(batch, dev), cfg)
        grads.append({k: t.float().cpu()
                      for k, t in leaves_with_path(grads_of(loss, p))})
    for k, gp in grads[0].items():
        gc = grads[1][k]
        assert bool(torch.isfinite(gc).all()), k
        assert float((gc - gp).norm()) <= 1e-3 * max(float(gp.norm()), 1e-12), k


def test_mamba2_train_steps_are_bit_reproducible(cuda):
    """Two seeded ``make_train_step`` runs of full-width Mamba2-370M cut to
    4 layers (B = 4, S = 256, AdamW, 2 steps each, in one process) leave
    bit-identical parameters and optimizer moments: no sum on the step's
    path (the scan kernels forward and backward, the embedding's gradient,
    the losses and the optimizer) depends on launch order."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, make_batch, to_device
    from repro_torch.launch.steps import init_train_state, make_train_step
    from repro_torch.optim import OptimizerConfig
    from repro_torch.optim.optimizer import leaves_with_path

    cfg = dataclasses.replace(get_config("mamba2-370m"), n_layers=4)
    ocfg = OptimizerConfig(lr=2e-3)
    dc = DataConfig(seed=0, global_batch=4, seq_len=256)
    runs = []
    for _ in range(2):
        state = init_train_state(cfg, ocfg, seed=0, device=cuda)
        step = make_train_step(cfg, ocfg, remat="none")
        for i in range(2):
            state, _ = step(state, to_device(make_batch(cfg, dc, i), cuda))
        torch.cuda.synchronize()
        runs.append(dict(
            (f"{part}/{k}", t.detach().clone())
            for part, tree in (("params", state["params"]),
                               ("mu", state["opt"].mu),
                               ("nu", state["opt"].nu))
            for k, t in leaves_with_path(tree)))
        del state
    assert runs[0].keys() == runs[1].keys()
    differ = [k for k in runs[0] if not torch.equal(runs[0][k], runs[1][k])]
    assert not differ, differ


def _tree_to(tree, dev):
    return {k: _tree_to(v, dev) if isinstance(v, dict) else
            v.detach().clone().to(dev) for k, v in tree.items()}


def test_kernels_without_backward_refuse_autograd_on_card(cuda):
    """The flash route of ``mha`` (``attn_impl="chunked"``) and the gated
    projection raise under autograd on the card rather than drop the
    gradients; under ``no_grad`` both run."""
    from repro_torch.kernels.morph_matmul import morph_matmul
    from repro_torch.models.model import init_params, loss_fn
    from repro_torch.optim import trainable

    cfg = smoke_config("tinyllama-1.1b").scaled(attn_impl="chunked")
    p = trainable(init_params(cfg, seed=2, device=cuda))
    batch = {"tokens": torch.arange(12, device=cuda)[None] % cfg.vocab_size,
             "targets": torch.arange(1, 13, device=cuda)[None] % cfg.vocab_size}
    with pytest.raises(RuntimeError, match="no backward"):
        loss_fn(p, batch, cfg)
    with torch.no_grad():
        loss, _ = loss_fn(p, batch, cfg)
    assert bool(torch.isfinite(loss))
    x = torch.randn(2, 3, 64, device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        morph_matmul(x, torch.randn(64, 32, device=cuda), active_n=16)


def test_mamba2_smoke_model_on_card_matches_cpu(cuda):
    """The mamba2 smoke model (f32) on the card (ssd_scan and morph_matmul
    kernels) against the plain versions on the CPU: prefill of a
    multi-chunk prompt, decode at mixed widths and a verify pass, logits
    and every cache leaf to 1e-3."""
    from repro_torch.core import elastic
    from repro_torch.kernels import ssd_scan as SSD
    from repro_torch.models.model import (decode_step, init_params, prefill,
                                          verify_step)

    cfg = smoke_config("mamba2-370m")
    p_cpu = init_params(cfg, seed=3, device="cpu")

    def move(t, dev):
        return ({k: move(v, dev) for k, v in t.items()} if isinstance(t, dict)
                else t.to(dev))

    outs = []
    for dev, p in (("cpu", p_cpu), (cuda, move(p_cpu, cuda))):
        act = elastic.active_widths_batch(cfg, [0.5, 1.0], device=dev)
        prompt = torch.arange(1, 40, device=dev)[None] % cfg.vocab_size
        n0 = SSD.launch_count()
        lg, cache = prefill(p, {"tokens": prompt}, cfg, per_slot=True,
                            slot=1, n_slots=2)
        if dev != "cpu":
            assert SSD.launch_count() == n0 + cfg.n_groups
        got = [lg]
        toks = torch.tensor([[5, 9, 3], [2, 4, 6]], device=dev)
        for t in range(toks.shape[1]):
            lg, cache = decode_step(p, cache, toks[:, t:t + 1], cfg,
                                    active=act)
            got.append(lg)
        vl, pend = verify_step(p, cache, toks, cfg, active=act)
        got += [vl] + [a for a in pend["stack"]["pos0"].values()]
        got += [a for a in cache["stack"]["pos0"].values()]
        outs.append([t.float().cpu() for t in got])
    for a, b in zip(*outs):
        torch.testing.assert_close(b, a, atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(2, 64, 4, 2, 32, True, 0),
                                   (1, 200, 8, 2, 64, True, 0),
                                   (1, 100, 4, 4, 16, True, 8),
                                   (2, 40, 2, 1, 128, False, 0),
                                   (2, 131, 6, 3, 40, True, 70),
                                   (1, 1, 4, 2, 64, True, 0),
                                   (1, 17, 4, 2, 64, True, 0),
                                   (1, (17, 50), 4, 2, 64, False, 0),
                                   (1, (50, 17), 4, 2, 64, True, 0),
                                   (1, 33, 2, 1, 20, True, 0),
                                   (2, 320, 16, 8, 128, True, 0)])
def test_flash_attention_kernel_matches_plain(cuda, dtype, shape):
    """The flash kernel against its plain version: GQA at B = 2, a ragged
    S = 200 (last query and key tiles cut short), a window of 8 (rows whose
    first visited tile is wholly masked), non-causal at hd 128, a window of
    70 at S = 131 and hd 40 (not a multiple of 16, zero-padded), Sq = 1 and
    17 (fewer rows than a warp's 16 or a block's 64), Sq != Sk both ways,
    hd 20 (rows not 16-byte aligned: element copies), and internvl2-2b's
    prompt pass (256 patches + 64 tokens, 16 / 8 heads of 128, causal;
    two requests of its eight). S is Sq = Sk or
    (Sq, Sk). Through the model-layout wrapper and the flat entry point."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ops

    B, S, H, KV, hd, causal, window = shape
    Sq, Sk = S if isinstance(S, tuple) else (S, S)
    g = torch.Generator(device=cuda).manual_seed(11)
    q = torch.randn(B, Sq, H, hd, generator=g, device=cuda).to(dtype)
    k = torch.randn(B, Sk, KV, hd, generator=g, device=cuda).to(dtype)
    v = torch.randn(B, Sk, KV, hd, generator=g, device=cuda).to(dtype)
    n0 = FA.launch_count()
    o = ops.flash_attention_bshd(q, k, v, causal=causal, window=window)
    assert FA.launch_count() == n0 + 1
    flat = [t.transpose(1, 2).reshape(-1, t.shape[1], hd).contiguous()
            for t in (q, k, v)]
    want = FA.flash_attention_plain(*flat, group=H // KV, causal=causal,
                                    window=window)
    o_flat = FA.flash_attention(*flat, group=H // KV, causal=causal,
                                window=window)
    torch.cuda.synchronize()
    assert o.dtype == dtype and bool(torch.isfinite(o.float()).all())
    _close(o.transpose(1, 2).reshape(-1, Sq, hd), want, dtype)
    _close(o_flat, want, dtype)


def test_flash_attention_routes_by_dtype(cuda):
    """bf16 inputs reach the tensor-core kernel and f32 inputs the FMA
    kernel; both count as flash_attention launches."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ops

    g = torch.Generator(device=cuda).manual_seed(12)
    q = torch.randn(1, 64, 4, 64, generator=g, device=cuda)
    k = torch.randn(1, 64, 2, 64, generator=g, device=cuda)
    for dtype, route in ((torch.bfloat16, "tc"), (torch.float32, "fma")):
        n0, r0 = FA.launch_count(), FA.route_counts()
        ops.flash_attention_bshd(q.to(dtype), k.to(dtype), k.to(dtype))
        r1 = FA.route_counts()
        assert FA.launch_count() == n0 + 1
        assert r1[route] == r0[route] + 1
        assert sum(r1.values()) == sum(r0.values()) + 1


@pytest.mark.parametrize("cache", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("group", [1, 4])
def test_flash_decode_kernel_matches_plain(cuda, cache, group):
    """The decode kernel against its plain version at kv_len 0, 1, 77 and
    S (given as an int and as a device scalar), several splits (S = 300),
    an int8 cache with bf16 scales, bf16 queries with a bf16 cache."""
    from repro_torch.kernels import flash_decode as FDK
    from repro_torch.models.layers import quantize_kv

    BKV, S, hd = 3, 300, 64
    g = torch.Generator(device=cuda).manual_seed(12)
    qdt = torch.bfloat16 if cache == "bf16" else torch.float32
    q = torch.randn(BKV * group, hd, generator=g, device=cuda).to(qdt)
    k = torch.randn(BKV, S, hd, generator=g, device=cuda)
    v = torch.randn(BKV, S, hd, generator=g, device=cuda)
    ks = vs = None
    if cache == "int8":
        k, ks = quantize_kv(k)
        v, vs = quantize_kv(v)
    elif cache == "bf16":
        k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
    for n in (0, 1, 77, S):
        for kv_len in (n, torch.tensor([n], dtype=torch.int32, device=cuda)):
            n0 = FDK.launch_count()
            got = FDK.flash_decode(q, k, v, kv_len, ks, vs, group=group)
            assert FDK.launch_count() == n0 + 1
            want = FDK.flash_decode_plain(q, k, v, n, ks, vs, group=group)
            torch.cuda.synchronize()
            assert got.dtype == qdt
            _close(got, want, qdt)
            if n == 0:
                assert not bool(got.any())


def test_cuda_tensors_reach_the_flash_kernels_never_the_plain(cuda,
                                                             monkeypatch):
    """On CUDA tensors the chunked prompt pass launches the flash kernel
    once per attention layer and flash_decode launches its kernel; the
    plain versions and the model's chunked attention are never called.
    The chunked prompt pass on the card matches the CPU's to 1e-3."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import flash_decode as FDK
    from repro_torch.models import layers as L
    from repro_torch.models.model import init_params, prefill

    cfg = dataclasses.replace(smoke_config("tinyllama-1.1b"),
                              attn_impl="chunked", attn_chunk=8)
    p_cpu = init_params(cfg, seed=3, device="cpu")
    prompt = (torch.arange(1, 30)[None] * 7) % cfg.vocab_size
    want, _ = prefill(p_cpu, {"tokens": prompt}, cfg)

    def banned(*a, **k):
        raise AssertionError("a plain version ran on CUDA tensors")

    for mod, name in ((FA, "flash_attention_plain"),
                      (FDK, "flash_decode_plain"),
                      (L, "attention_chunked")):
        monkeypatch.setattr(mod, name, banned)

    def move(t):
        return ({k: move(v) for k, v in t.items()} if isinstance(t, dict)
                else t.to(cuda))

    n0 = FA.launch_count()
    got, _ = prefill(move(p_cpu), {"tokens": prompt.to(cuda)}, cfg)
    assert FA.launch_count() == n0 + cfg.n_groups * cfg.period
    torch.testing.assert_close(got.cpu(), want, atol=1e-3, rtol=1e-3)
    q = torch.randn(8, 16, device=cuda)
    kv = torch.randn(2, 64, 16, device=cuda)
    n0 = FDK.launch_count()
    FDK.flash_decode(q, kv, kv, 10, group=4)
    assert FDK.launch_count() == n0 + 1


# ---------------------------------------------------------------------------
# the decode-attention core (csrc/decode_attn.cuh) under both kernels
# ---------------------------------------------------------------------------


def _serving_cache(g, cuda, shape, cache):
    """k, v and (int8) bf16 scales of a cache of ``shape`` (the last axis
    hd) in ``cache`` dtype."""
    from repro_torch.models.layers import quantize_kv

    k = torch.randn(shape, generator=g, device=cuda)
    v = torch.randn(shape, generator=g, device=cuda)
    if cache == "int8":
        (k, ks), (v, vs) = quantize_kv(k), quantize_kv(v)
        return k, v, ks, vs
    dt = torch.bfloat16 if cache == "bf16" else torch.float32
    return k.to(dt), v.to(dt), None, None


@pytest.mark.parametrize("cache", ["bf16", "int8", "int8_f32_scales",
                                   "f32"])
def test_flash_decode_serving_shape_matches_plain(cuda, cache):
    """The TinyLlama serving cache (32 KV rows of 512, group 8, hd 64):
    bf16 and int8 (bf16 or f32 scales) on the tensor cores with bf16
    queries, f32 on the FMA route with f32 queries; kv_len 0, 1, 37 (every
    split empty but the first), 300 and 512 on the device."""
    from repro_torch.kernels import flash_decode as FDK

    BKV, G, S, hd = 32, 8, 512, 64
    g = torch.Generator(device=cuda).manual_seed(21)
    k, v, ks, vs = _serving_cache(g, cuda, (BKV, S, hd),
                                  cache.split("_")[0])
    if cache == "int8_f32_scales":
        ks, vs = ks.float(), vs.float()
    qdt = torch.float32 if cache == "f32" else torch.bfloat16
    q = torch.randn(BKV * G, hd, generator=g, device=cuda).to(qdt)
    assert FDK.plan(BKV, G, S, qdt, k.dtype, hd, cuda)[0] > 1
    route = "fma" if cache == "f32" else "tc"
    for n in (0, 1, 37, 300, 512):
        r0 = FDK.route_counts()
        got = FDK.flash_decode(q, k, v, torch.tensor([n], dtype=torch.int32,
                                                     device=cuda), ks, vs,
                               group=G)
        assert FDK.route_counts()[route] == r0[route] + 1
        want = FDK.flash_decode_plain(q, k, v, n, ks, vs, group=G)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(got.float()).all())
        _close(got, want, qdt)
        if n == 0:
            assert not bool(got.any())


def _fused_serving_case(cuda, cache, pos, S=1024, seed=22):
    """Full-width TinyLlama attention weights, B = 8 slots at mixed widths
    and positions ``pos`` over an S-row cache of ``cache`` dtype."""
    from repro_torch.configs import get_config
    from repro_torch.core import elastic

    cfg = get_config("tinyllama-1.1b")
    if cache == "int8":
        cfg = dataclasses.replace(cfg, kv_quant=True)
    dm, H, KV, hd, B = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, 8
    g = torch.Generator(device=cuda).manual_seed(seed)
    params = {n: torch.randn(*s, generator=g, device=cuda) / np.sqrt(s[0])
              for n, s in (("wq", (dm, H * hd)), ("wk", (dm, KV * hd)),
                           ("wv", (dm, KV * hd)), ("wo", (H * hd, dm)))}
    k, v, ks, vs = _serving_cache(g, cuda, (B, S, KV, hd), cache)
    c = {"k": k, "v": v}
    if cache == "int8":
        c.update(k_scale=ks, v_scale=vs)
    xdt = torch.float32 if cache == "f32" else torch.bfloat16
    x = torch.randn(B, 1, dm, generator=g, device=cuda).to(xdt)
    act = elastic.active_widths_batch(
        cfg, [0.25, 0.5, 1.0, 0.25, 0.5, 1.0, 0.5, 0.25], device=cuda)
    pos = torch.tensor(pos, dtype=torch.int32, device=cuda)
    return cfg, params, c, x, act, pos


@pytest.mark.parametrize("cache", ["bf16", "int8", "f32"])
@pytest.mark.parametrize("where", ["mixed", "first_split"])
def test_fused_decode_serving_shape_matches_plain(cuda, cache, where):
    """One full-width TinyLlama attention layer, B = 8 over a 1024-row
    cache: the kernels against the plain version, output and written cache
    (int8 values within 1: f32 sums in another order may move a value across
    a .5 edge). "first_split": every slot below position 64, so every split
    of every (slot, head) is empty but the first."""
    pos = ([0, 1, 63, 64, 200, 511, 777, 1023] if where == "mixed"
           else [0, 1, 2, 7, 30, 31, 62, 63])
    cfg, params, cache_, x, act, pos_t = _fused_serving_case(cuda, cache,
                                                             pos)
    assert FD.attn_plan(8, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, 1024,
                        cache_["k"].dtype, cuda)[0] > 1
    c_k = {n: t.clone() for n, t in cache_.items()}
    c_p = {n: t.clone() for n, t in cache_.items()}
    o_k, _ = FD.fused_decode_step(params, x, c_k, pos_t, cfg, active=act)
    o_p, _ = FD.fused_decode_plain(params, x, c_p, pos_t, cfg, act["q_dim"],
                                   act["kv_dim"])
    torch.cuda.synchronize()
    _close(o_k, o_p, x.dtype)
    for n in c_k:
        if c_k[n].dtype == torch.int8:
            assert int((c_k[n].int() - c_p[n].int()).abs().max()) <= 1, n
        else:
            _close(c_k[n], c_p[n], c_k[n].dtype)


@pytest.mark.parametrize("kernel", ["flash_decode", "fused_decode"])
@pytest.mark.parametrize("cache", ["bf16", "int8"])
def test_decode_attn_kernels_are_deterministic(cuda, kernel, cache):
    """Repeated launches on the same inputs are bit-identical: the splits'
    partials are merged in split order through the cluster's shared
    memory, with no atomics."""
    from repro_torch.kernels import flash_decode as FDK

    if kernel == "flash_decode":
        g = torch.Generator(device=cuda).manual_seed(23)
        k, v, ks, vs = _serving_cache(g, cuda, (32, 512, 64), cache)
        q = torch.randn(256, 64, generator=g, device=cuda).to(torch.bfloat16)
        n = torch.tensor([479], dtype=torch.int32, device=cuda)

        def run():
            return FDK.flash_decode(q, k, v, n, ks, vs, group=8)
    else:
        cfg, params, c, x, act, pos = _fused_serving_case(
            cuda, cache, [5, 100, 333, 512, 640, 700, 900, 1000])
        base = {nm: t.clone() for nm, t in c.items()}

        def run():
            for nm in c:  # the same cache before every launch
                c[nm].copy_(base[nm])
            return FD.fused_decode_step(params, x, c, pos, cfg,
                                        active=act)[0]
    first = run().clone()
    for _ in range(3):
        assert torch.equal(run(), first)


@pytest.mark.parametrize("shape", [(8, 2048, 32768), (8, 5632, 2048),
                                   (40, 5632, 2048)],
                         ids=["logits", "wo_8", "wo_40"])
def test_bf16_matmul_sums_in_f32(cuda, shape):
    """The port's ungated bf16 products (``layers.matmul``: the prompt
    pass's projections and every step's logits) against the f32-sum result:
    the operands upcast, the product in f32, then rounded once to bf16, as
    the reference sums them (``preferred_element_type=f32``). At most one
    bf16 step apart, at the split-K-prone shapes of the TinyLlama logits and
    the MLP's output projection (K = 5632) at 8 and 40 rows.

    The operands are small integers (x in [-8, 8], w in [-8, 8] / 64), so
    every partial sum is exact in f32 (at most 19 significant bits) and the
    f32 sum does not depend on its order: an f32 reduction gives exactly
    the reference, while split-K partials rounded to bf16 (8 bits) would
    move outputs by several steps. (With real-valued operands two f32 sums
    in different orders differ by more than a bf16 step of an output that
    cancels to near zero, which says nothing about the reduction.)"""
    from repro_torch.models import layers as L

    M, K, N = shape
    g = torch.Generator(device=cuda).manual_seed(24)
    x = torch.randint(-8, 9, (M, K), generator=g, device=cuda).to(
        torch.bfloat16)
    w = torch.randint(-8, 9, (K, N), generator=g, device=cuda).float() / 64
    got = L.matmul(x, w, torch.bfloat16)
    want = (x.float() @ w).to(torch.bfloat16)
    torch.cuda.synchronize()
    _, e = torch.frexp(torch.maximum(got.float().abs(), want.float().abs()))
    step = torch.ldexp(torch.ones_like(got, dtype=torch.float32), e - 8)
    bad = (got.float() - want.float()).abs() > step
    assert not bool(bad.any()), (
        f"{int(bad.sum())} of {bad.numel()} outputs more than one bf16 step "
        f"from the f32-sum result")


@pytest.mark.parametrize("kernel", ["fused_verify_g8", "fused_verify_tree",
                                    "ssd_scan", "ssd_scan_bwd"])
def test_verify_and_scan_kernels_are_deterministic(cuda, kernel):
    """Repeated launches on the same inputs are bit-identical: the verify's
    splits merge in split order through the cluster's shared memory, the
    scan's tiles meet in a fixed order through its workspace, and the
    scan's backward sums each step's decay terms from per-thread partials
    in index order, with no atomics in any. The backward runs at
    Mamba2-370M's width (32 heads of 64, n = 128) over 300 steps (a ragged
    last tile), on one forward's kept workspace."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as SSD

    if kernel == "ssd_scan_bwd":
        g = torch.Generator(device=cuda).manual_seed(30)
        x, dt, A, B, C = _ssd_inputs(g, (2, 300, 32, 64, 1, 128),
                                     torch.float32)
        A_bh = A.expand(2, 32).contiguous()
        y, st, ws = SSD.launch_bshn(x, dt, A_bh, B, C, keep_workspace=True)
        dy = torch.randn(y.shape, generator=g, device=cuda)
        ds = torch.randn(st.shape, generator=g, device=cuda)

        def run():
            return torch.cat([t.float().flatten() for t in SSD.launch_bwd(
                x, dt, A_bh, B, C, ws, dy, ds)])
    elif kernel == "ssd_scan":
        g = torch.Generator(device=cuda).manual_seed(29)
        x, dt, A, B, C = _ssd_inputs(g, (1, 300, 8, 64, 2, 128),
                                     torch.float32)

        def run():
            y, st = ops.ssd_scan_bshn(x, dt, A, B, C, chunk=64)
            return torch.cat([y.flatten(), st.flatten()])
    else:
        variant = ("linear_bf16_g8" if kernel == "fused_verify_g8"
                   else "tree_int8_g8")
        cfg, dt, params, cache, x, pos, act, nd, tb = _verify_case(
            cuda, variant, seed=31)

        def run():
            o, kv = FD.fused_verify(params, x, cache, pos, cfg, active=act,
                                    node_depth=nd, tree_bias=tb)
            return torch.cat([o.float().flatten(), kv["k"].float().flatten(),
                              kv["v"].float().flatten()])
    first = run().clone()
    for _ in range(3):
        assert torch.equal(run(), first)


# ---------------------------------------------------------------------------
# the block-paged cache: the page-table half of fused_decode / fused_verify
# ---------------------------------------------------------------------------


def _paged_twin(cuda, cache, window=0, S=512, ps=16, seed=40):
    """Full-width TinyLlama attention weights, B = 8 slots at mixed widths
    over a dense cache of ``S`` rows (the window's, under one) and its paged
    twin: the same rows scattered into shuffled pages of a worst-case pool
    (one scratch page per slot without a window), slots 6 and 7 sharing
    their first 4 pages and the rows in them."""
    from repro_torch.configs import get_config
    from repro_torch.core import elastic

    cfg = dataclasses.replace(get_config("tinyllama-1.1b"),
                              kv_quant=cache == "int8", sliding_window=window)
    dm, H, KV, hd, B = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, 8
    Sc = window or S
    P = Sc // ps
    n_pages = B * (P + (0 if window else 1))
    g = torch.Generator(device=cuda).manual_seed(seed)
    params = {n: torch.randn(*s, generator=g, device=cuda) / np.sqrt(s[0])
              for n, s in (("wq", (dm, H * hd)), ("wk", (dm, KV * hd)),
                           ("wv", (dm, KV * hd)), ("wo", (H * hd, dm)))}
    k, v, ks, vs = _serving_cache(g, cuda, (B, Sc, KV, hd), cache)
    dense = {"k": k, "v": v}
    if cache == "int8":
        dense.update(k_scale=ks, v_scale=vs)
    table = torch.randperm(n_pages, generator=g, device=cuda)[:B * P]
    table = table.view(B, P).to(torch.int32)
    if not window:
        for t in dense.values():
            t[7, :4 * ps] = t[6, :4 * ps]
        table[7, :4] = table[6, :4]
    pool = {}
    for n, t in dense.items():
        pool[n] = torch.zeros((n_pages, ps) + tuple(t.shape[2:]),
                              dtype=t.dtype, device=cuda)
        pool[n][table.long().flatten()] = t.reshape(
            (B * P, ps) + tuple(t.shape[2:]))
    act = elastic.active_widths_batch(
        cfg, [0.25, 0.5, 1.0, 0.25, 0.5, 1.0, 0.5, 0.25], device=cuda)
    xdt = torch.float32 if cache == "f32" else torch.bfloat16
    return cfg, params, dense, pool, table, act, xdt, g


@pytest.mark.parametrize("cache", ["bf16", "int8", "f32"])
@pytest.mark.parametrize("window", [0, 64], ids=["full", "window64"])
def test_paged_fused_kernels_match_plain(cuda, cache, window):
    """One full-width TinyLlama attention layer over a page pool (page 16,
    shuffled pages, two slots sharing four), B = 8 at mixed positions: the
    decode launch against ``fused_decode_plain`` (output and the pool after
    its write: int8 values within 1, as the dense test allows) and the
    linear verify launch (S = 5) against ``fused_verify_plain`` (output,
    candidates, the pool left as it was), each counted as paged and on its
    dtype's route."""
    cfg, params, _, pool, table, act, xdt, g = _paged_twin(cuda, cache,
                                                           window)
    ps = 16
    dm = cfg.d_model
    pos = torch.tensor([0, 1, 63, 64, 200, 333, 450, 505], dtype=torch.int32,
                       device=cuda)
    route = "fma" if cache == "f32" else "tc"
    x = torch.randn(8, 1, dm, generator=g, device=cuda).to(xdt)
    c_k = {n: t.clone() for n, t in pool.items()}
    c_p = {n: t.clone() for n, t in pool.items()}
    n0, r0 = FD.paged_launch_count(), FD.route_counts()
    o_k, _ = FD.fused_decode_step(params, x, c_k, pos, cfg, active=act,
                                  pages=table, page_size=ps)
    assert FD.paged_launch_count() == n0 + 1
    assert FD.route_counts()[route] == r0[route] + 1
    o_p, _ = FD.fused_decode_plain(params, x, c_p, pos, cfg, act["q_dim"],
                                   act["kv_dim"], table, ps)
    torch.cuda.synchronize()
    _close(o_k, o_p, xdt)
    for n in pool:
        if pool[n].dtype == torch.int8:
            assert int((c_k[n].int() - c_p[n].int()).abs().max()) <= 1, n
        else:
            _close(c_k[n], c_p[n], pool[n].dtype)
    x = torch.randn(8, 5, dm, generator=g, device=cuda).to(xdt)
    before = {n: t.clone() for n, t in pool.items()}
    n0, r0 = FD.paged_verify_launch_count(), FD.verify_route_counts()
    o_k, kv_k = FD.fused_verify(params, x, pool, pos, cfg, active=act,
                                pages=table, page_size=ps)
    assert FD.paged_verify_launch_count() == n0 + 1
    assert FD.verify_route_counts()[route] == r0[route] + 1
    o_p, kv_p = FD.fused_verify_plain(params, x, pool, pos, cfg,
                                      act["q_dim"], act["kv_dim"],
                                      pages=table, page_size=ps)
    torch.cuda.synchronize()
    _close(o_k, o_p, xdt)
    for n in ("k", "v"):
        _close(kv_k[n], kv_p[n], xdt)
    for n in pool:  # the pool is read only
        assert torch.equal(pool[n], before[n]), n


@pytest.mark.parametrize("cache", ["bf16", "int8"])
def test_paged_launch_bit_identical_to_dense(cuda, cache):
    """A paged launch through a bucketed table (8 of a slot's 32 pages) and
    its dense twin over the same contents give bit-identical outputs when
    the paged launch plans its splits from the slot's full capacity
    (``plan_len`` = 512, the dense cache's S): both visit the same rows in
    the same splits and order. Decode (output and the written rows) and
    linear verify (output and candidates)."""
    cfg, params, dense, pool, table, act, xdt, g = _paged_twin(cuda, cache)
    ps, S = 16, 512
    pos = torch.tensor([0, 1, 17, 40, 64, 90, 100, 126], dtype=torch.int32,
                       device=cuda)
    bucket = table[:, :8].contiguous()
    x = torch.randn(8, 1, cfg.d_model, generator=g, device=cuda).to(xdt)
    o_d, _ = FD.fused_decode_step(params, x, dense, pos, cfg, active=act)
    o_p, _ = FD.fused_decode_step(params, x, pool, pos, cfg, active=act,
                                  pages=bucket, page_size=ps, plan_len=S)
    torch.cuda.synchronize()
    assert torch.equal(o_d, o_p)
    pl = pos.long()
    rows = (bucket.long()[torch.arange(8, device=cuda), pl // ps], pl % ps)
    for n in dense:
        assert torch.equal(dense[n][torch.arange(8, device=cuda), pl],
                           pool[n][rows]), n
    x = torch.randn(8, 5, cfg.d_model, generator=g, device=cuda).to(xdt)
    o_d, kv_d = FD.fused_verify(params, x, dense, pos, cfg, active=act)
    o_p, kv_p = FD.fused_verify(params, x, pool, pos, cfg, active=act,
                                pages=bucket, page_size=ps, plan_len=S)
    torch.cuda.synchronize()
    assert torch.equal(o_d, o_p)
    assert torch.equal(kv_d["k"], kv_p["k"]) and torch.equal(kv_d["v"],
                                                             kv_p["v"])


def test_engine_on_card_paged_fused_equals_dense(cuda):
    """Full-width TinyLlama-1.1B (seeded random weights), fused: the paged
    engine (page 16, worst-case pool) emits the dense engine's tokens on
    six requests whose prompts share a 48-token (three-page) prefix, with
    radix hits, exact page accounting and nothing built after warmup."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    from repro_torch.models.paged import PagedLayout
    from repro_torch.runtime.serving import Request, ServingEngine

    cfg = get_config("tinyllama-1.1b")
    params = init_params(cfg, seed=0, device=cuda)
    rng = np.random.default_rng(3)
    prefix = tuple(int(t) for t in rng.integers(1, cfg.vocab_size, 48))
    reqs = [(prefix + tuple(int(t) for t in rng.integers(
        1, cfg.vocab_size, int(rng.integers(1, 20)))), 12) for _ in range(6)]
    streams = []
    for paged in (None, PagedLayout(page_size=16)):
        eng = ServingEngine(params, cfg, batch_size=4, cache_capacity=256,
                            prefill_threshold=8, fused=True, paged=paged,
                            device=cuda)
        eng.warmup()
        for i, (prompt, new) in enumerate(reqs):
            eng.submit(Request(rid=i, prompt=prompt, max_new_tokens=new))
        while eng.queue or eng.n_active:
            eng.step()
            eng.check_paged_invariants()
        assert eng.ctrl.stats["compiles"] == eng.compiles_after_warmup
        streams.append({r.rid: r.generated for r in eng.completed})
        if paged is not None:
            st = eng.page_pool_stats()[cfg.n_groups]
            assert st["radix_hits"] > 0, st
    assert len(streams[0]) == 6
    assert streams[0] == streams[1]


def test_smoke_paged_unfused_decode_on_card_matches_dense(cuda):
    """The f32 smoke model, unfused, on the card: twelve decode steps over
    a paged cache (page 4, a shuffled table cut to the bucket that covers
    every slot) give the dense cache's logits within 1e-5. The attention
    is a PyTorch reduction over the bucket's positions rather than the
    dense cache's, so bit identity is not promised."""
    from repro_torch.core import elastic
    from repro_torch.models import model as TM
    from repro_torch.models.paged import PagedLayout, init_paged_cache

    cfg = smoke_config("tinyllama-1.1b")
    params = TM.init_params(cfg, seed=1, device=cuda)
    B, cap, ps = 3, 32, 4
    layout = PagedLayout(page_size=ps)
    act = elastic.active_widths_batch(cfg, [0.5, 1.0, 1.0], device=cuda)
    dense = TM.init_decode_cache(cfg, B, cap, per_slot=True, device=cuda)
    paged = init_paged_cache(cfg, B, cap, layout, device=cuda)
    for c in (dense, paged):
        c["pos"].copy_(torch.tensor([0, 3, 7], dtype=torch.int32))
    g = torch.Generator().manual_seed(2)
    n_pages = layout.pool_pages(cfg, B, cap)
    table = torch.randperm(n_pages, generator=g)[:B * cap // ps].view(
        B, cap // ps).to(dtype=torch.int32, device=cuda)
    for step in range(12):
        tok = torch.randint(1, cfg.vocab_size, (B, 1), generator=g).to(cuda)
        need = int(paged["pos"].max()) // ps + 1
        bucket = layout.bucket_for(cfg, cap, need)
        l_d, _ = TM.decode_step(params, dense, tok, cfg, active=act)
        l_p, _ = TM.decode_step(params, paged, tok, cfg, active=act,
                                pages=table[:, :bucket].contiguous(),
                                page_size=ps)
        torch.cuda.synchronize()
        torch.testing.assert_close(l_p, l_d, atol=1e-5, rtol=0,
                                   msg=f"step {step}")


# ---------------------------------------------------------------------------
# encoder-decoder and frontend models: cross-attention decode on
# flash_decode, unmasked prompt-pass attention on flash_attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("qdtype", [torch.float32, torch.bfloat16],
                         ids=["q_f32", "q_bf16"])
def test_flash_decode_cross_shape_matches_plain(cuda, qdtype):
    """Whisper's cross-attention decode: 8 slots x 8 heads over 64 KV rows
    of 1500 encoder positions, hd 64, group 1, a bf16 cache (the
    tensor-core route) with f32 and bf16 queries, kv_len = 1500."""
    from repro_torch.kernels import flash_decode as FDK

    g = torch.Generator(device=cuda).manual_seed(21)
    k, v, _, _ = _serving_cache(g, cuda, (64, 1500, 64), "bf16")
    q = torch.randn(64, 64, generator=g, device=cuda).to(qdtype)
    n0, r0 = FDK.launch_count(), FDK.route_counts()["tc"]
    got = FDK.flash_decode(q, k, v, 1500, group=1)
    assert FDK.launch_count() == n0 + 1
    assert FDK.route_counts()["tc"] == r0 + 1
    want = FDK.flash_decode_plain(q, k, v, 1500, group=1)
    torch.cuda.synchronize()
    assert got.dtype == qdtype
    _close(got, want, qdtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("sq,sk", [(16, 1500), (1500, 1500)],
                         ids=["cross_prompt", "encoder"])
def test_flash_attention_unmasked_whisper_shapes(cuda, dtype, sq, sk):
    """Non-causal, no window, 8 heads of 64 (group 1): the decoder's cross
    prompt pass (16 queries against 1500 keys) and the encoder's
    self-attention (1500 x 1500; 1500 = 23 x 64 + 28, a ragged last tile),
    through the model-layout wrapper, against the plain version."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ops

    g = torch.Generator(device=cuda).manual_seed(22)
    q = torch.randn(1, sq, 8, 64, generator=g, device=cuda).to(dtype)
    k = torch.randn(1, sk, 8, 64, generator=g, device=cuda).to(dtype)
    v = torch.randn(1, sk, 8, 64, generator=g, device=cuda).to(dtype)
    n0 = FA.launch_count()
    o = ops.flash_attention_bshd(q, k, v, causal=False)
    assert FA.launch_count() == n0 + 1
    flat = [t.transpose(1, 2).reshape(-1, t.shape[1], 64).contiguous()
            for t in (q, k, v)]
    want = FA.flash_attention_plain(*flat, group=1, causal=False)
    torch.cuda.synchronize()
    _close(o.transpose(1, 2).reshape(-1, sq, 64), want, dtype)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("arch", ["whisper-base", "internvl2-2b"])
def test_encdec_smoke_models_on_card_match_cpu(cuda, arch, fused):
    """The f32 smoke models on the card against the plain versions on the
    CPU: a prompt pass under ``attn_impl="chunked"`` (whisper: frames;
    internvl: patches), then 3 decode steps at mixed widths, logits and
    every cache leaf to 1e-3. On the card the prompt pass launches
    flash_attention once per attention layer (whisper: 2 encoder layers,
    and per decoder layer its self- and cross-attention), and every
    whisper decode step launches flash_decode once per decoder layer."""
    from repro_torch.core import elastic
    from repro_torch.data import pipeline as TD
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import flash_decode as FDK
    from repro_torch.models.model import decode_step, init_params, prefill

    cfg = dataclasses.replace(smoke_config(arch), attn_impl="chunked")
    p_cpu = init_params(cfg, seed=3, device="cpu")
    b = TD.make_batch(cfg, TD.DataConfig(seed=1, global_batch=2,
                                         seq_len=16), 0)

    def move(t, dev):
        return ({k: move(v, dev) for k, v in t.items()} if isinstance(t, dict)
                else t.to(dev))

    outs = []
    for dev, p in (("cpu", p_cpu), (cuda, move(p_cpu, cuda))):
        act = elastic.active_widths_batch(cfg, [0.5, 1.0], device=dev)
        n_fa, n_fd = FA.launch_count(), FDK.launch_count()
        lg, cache = prefill(p, TD.to_device(b, dev), cfg, cache_extra=4,
                            per_slot=True)
        if dev != "cpu":
            per_layer = 2 if cfg.is_encdec else 1
            assert FA.launch_count() == (n_fa + cfg.enc_layers
                                         + per_layer * cfg.n_layers)
        got = [lg]
        toks = torch.tensor([[5, 9, 3], [2, 4, 6]], device=dev)
        for t in range(toks.shape[1]):
            lg, cache = decode_step(p, cache, toks[:, t:t + 1], cfg,
                                    active=act, fused=fused)
            got.append(lg)
        if dev != "cpu":
            n_cross = 3 * cfg.n_layers if cfg.is_encdec else 0
            assert FDK.launch_count() == n_fd + n_cross
        for layer in cache["stack"].values():
            got += list(layer.values())
        outs.append([t.float().cpu() for t in got])
    for a, c in zip(*outs):
        torch.testing.assert_close(c, a, atol=1e-3, rtol=1e-3)


def _fused_factory(cuda, cfg, params):
    from repro_torch.runtime.serving import ServingEngine
    from repro_torch.runtime.speculative import SpecConfig

    def make():
        eng = ServingEngine(params, cfg, batch_size=3, cache_capacity=32,
                            prefill_threshold=4, fused=True,
                            speculative=SpecConfig(ks=(2,)), device=cuda)
        eng.warmup()
        return eng
    return make


def test_fused_chaos_drive_on_card_is_token_identical(cuda):
    """The f32 smoke config, fused, linear speculation, on the card: three
    planned failures (decode, verify, prefill), two standbys ping-ponged;
    every stream equals the fault-free run's, the counters land on its
    totals, and the replays ran through chunks on the fused verify
    kernel."""
    from repro_torch.kernels import fused_decode as FD
    from repro_torch.models.model import init_params
    from repro_torch.runtime.fault_tolerance import (ExecutorSupervisor,
                                                     FailurePlan)
    from repro_torch.runtime.serving import poisson_trace

    cfg = smoke_config("tinyllama-1.1b")
    make = _fused_factory(cuda, cfg, init_params(cfg, seed=0, device=cuda))

    def trace():
        return poisson_trace(10, 1e6, seed=5, vocab=cfg.vocab_size,
                             prompt_len=(1, 9), interactive_frac=0.3)

    counter = FailurePlan()
    ref_sup = ExecutorSupervisor(make, failure_plan=counter)
    ref_sup.run_trace(trace())
    ref = ref_sup.engine
    want = ({r.rid: r.generated for r in ref.completed},
            (ref.step_count, ref.decode_launches, ref.prefills,
             ref.spec_verify_launches, ref.spec_generated_tokens))
    plan = FailurePlan(at_sites=tuple(
        (s, min(2, counter.site_counts[s]))
        for s in ("decode", "verify", "prefill")))
    engines, idx = [ref, make()], [0]
    ref.restore(engines[1].snapshot())  # back to a clean start

    def pingpong():
        idx[0] ^= 1
        return engines[idx[0]]

    v0 = FD.verify_launch_count()
    sup = ExecutorSupervisor(pingpong, failure_plan=plan, max_failovers=3)
    sup.run_trace(trace())
    eng = sup.engine
    assert sup.failovers == 3 and plan.fired_sites == set(plan.at_sites)
    got = ({r.rid: r.generated for r in eng.completed},
           (eng.step_count, eng.decode_launches, eng.prefills,
            eng.spec_verify_launches, eng.spec_generated_tokens))
    assert got == want
    assert sum(e.replay_chunk_launches for e in engines) > 0
    assert FD.verify_launch_count() > v0


def test_restored_cache_matches_source_on_card(cuda):
    """Snapshot a fused f32 engine mid-flight on the card and restore it
    onto another: on every live slot's committed rows the restored K/V
    (written by replay chunks on the fused verify kernel, and one-token
    launches on the fused decode kernel) equal the source's (written by
    decode and verify ticks) to f32 rounding, 1e-5."""
    from repro_torch.models.model import init_params
    from repro_torch.runtime.serving import poisson_trace

    cfg = smoke_config("tinyllama-1.1b")
    make = _fused_factory(cuda, cfg, init_params(cfg, seed=0, device=cuda))
    a, b = make(), make()
    for r in poisson_trace(6, 1e6, seed=11, vocab=cfg.vocab_size,
                           prompt_len=(1, 9), new_tokens=(12, 20)):
        a.submit(r)
    for _ in range(6):
        a.step()
    b.restore(a.snapshot())
    assert b.replay_chunk_launches > 0
    for d, g in a.groups.items():
        live = [(i, r.fed) for i, r in enumerate(g.slots) if r is not None]
        for layer_a, layer_b in zip(g.cache["stack"].values(),
                                    b.groups[d].cache["stack"].values()):
            for k in ("k", "v"):
                for i, fed in live:
                    torch.testing.assert_close(
                        layer_b[k][:, i, :fed], layer_a[k][:, i, :fed],
                        atol=1e-5, rtol=0)


def test_mamba2_restart_is_bit_identical_on_card(cuda, tmp_path):
    """Full-width Mamba2-370M cut to 4 layers (B = 4, S = 256, AdamW):
    ``TrainRunner`` with a checkpoint every 2 steps and a failure before
    step 3 ends with parameters and moments bit-identical to 4
    uninterrupted steps."""
    from repro_torch.checkpoint.checkpointing import leaves_with_path
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, make_batch
    from repro_torch.launch.steps import init_train_state, make_train_step
    from repro_torch.optim import OptimizerConfig
    from repro_torch.runtime.fault_tolerance import FailurePlan, TrainRunner

    cfg = dataclasses.replace(get_config("mamba2-370m"), n_layers=4)
    ocfg = OptimizerConfig(lr=2e-3)
    dc = DataConfig(seed=0, global_batch=4, seq_len=256)

    def init():
        return init_train_state(cfg, ocfg, seed=0, device=cuda)

    step = make_train_step(cfg, ocfg, remat="none")
    state = init()
    for i in range(4):
        state, _ = step(state, make_batch(cfg, dc, i))
    want = {k: t.detach().clone() for k, t in leaves_with_path(state)}
    runner = TrainRunner(cfg, make_train_step(cfg, ocfg, remat="none"), init,
                         dc, str(tmp_path), ckpt_every=2,
                         failure_plan=FailurePlan(at_steps=(3,)))
    got = dict(leaves_with_path(runner.run_with_restarts(4)))
    assert [m["step"] for m in runner.metrics_log] == [0, 1, 2, 2, 3]
    assert want.keys() == got.keys()
    differ = [k for k in want if not torch.equal(want[k], got[k])]
    assert not differ, differ


def _await_unit(asc, timeout_s=120.0):
    """Wait for the autoscaler's worker, then publish on this thread."""
    import time

    t0 = time.monotonic()
    while asc._pending and time.monotonic() - t0 < timeout_s:
        asc._drain_publish()
        time.sleep(0.01)
    asc._drain_publish()
    assert not asc._pending, "the background build never finished"


def test_verify_step_built_on_worker_stream_matches_main_thread(cuda):
    """A K = 4 draft and verify built and warmed by the autoscaler's worker
    thread, on its own stream, from parameters that require grad (the
    worker's thread starts with grad mode on, and the hand kernels refuse
    autograd): nothing raised (``dropped == 0``), its launches were counted
    apart (one S = 5 verify per layer), and the published verify gives
    outputs and a committed cache bit-identical to one built on the main
    thread, on the same inputs."""
    import threading

    from repro_torch.models.model import init_params
    from repro_torch.runtime.autoscale import AutoscaleConfig, Autoscaler
    from repro_torch.runtime.serving import ServingEngine
    from repro_torch.runtime.speculative import (SpecConfig,
                                                 verify_compile_key)

    cfg = smoke_config("tinyllama-1.1b")
    params = init_params(cfg, seed=0, device=cuda)
    stack = [params]
    while stack:  # every leaf requires grad, as fresh from training
        node = stack.pop()
        for t in node.values():
            if isinstance(t, dict):
                stack.append(t)
            else:
                t.requires_grad_(True)
    eng = ServingEngine(params, cfg, batch_size=3, cache_capacity=32,
                        prefill_threshold=4, fused=True,
                        speculative=SpecConfig(ks=(2,)), device=cuda)
    eng.warmup()
    depth = eng.ctrl.modes[-1].depth
    asc = Autoscaler(AutoscaleConfig(spec_ks=(4,))).bind(eng)
    v0 = FD.verify_launch_count()
    try:
        asc._schedule(("spec_k", depth, 4))
        _await_unit(asc)
    finally:
        asc.close()
    assert asc.stats["dropped"] == 0 and asc.stats["published_keys"] == 2
    assert threading.get_ident() not in asc.worker_idents
    assert FD.verify_launch_count() == v0
    rows = asc.build_launches["fused_verify_rows"]
    assert {s: n for s, n in rows.items() if n} == {5: depth * cfg.period}
    published = eng.ctrl.aux_step(verify_compile_key(depth, 4))
    main = eng.ctrl.aux_builders["verify"](depth, 4)()
    g = eng.groups[depth]
    gen = torch.Generator().manual_seed(3)
    cache = eng.executor.init_cache()
    for layer in cache["stack"].values():
        for k, t in layer.items():
            t.copy_(torch.randn(t.shape, generator=gen).to(t.dtype))
    cache["pos"].copy_(torch.tensor([3, 7, 11], dtype=cache["pos"].dtype))
    toks = torch.randint(0, cfg.vocab_size, (3, 5), generator=gen).to(cuda)
    dlg = torch.randn((3, 4, cfg.padded_vocab()), generator=gen).to(cuda)
    active = eng._active_for([1.0, 0.5, 1.0])
    outs = []
    with torch.no_grad():
        for fn in (published, main):
            c = {"pos": cache["pos"].clone(),
                 "stack": {pn: {k: t.clone() for k, t in layer.items()}
                           for pn, layer in cache["stack"].items()}}
            tok, n_acc, c = fn(eng.params, c, toks, dlg, active, g.keys,
                               0.0, 0)
            outs.append((tok, n_acc, c))
    (ta, na, ca), (tb, nb, cb) = outs
    assert torch.equal(ta, tb) and torch.equal(na, nb)
    for pn in ca["stack"]:
        for k in ca["stack"][pn]:
            assert torch.equal(ca["stack"][pn][k], cb["stack"][pn][k]), k


def test_block_until_ready_ignores_a_busy_side_stream(cuda):
    """``_block_until_ready`` waits for the current stream only: a kernel
    spinning ~0.5 s on another stream is still running when it returns."""
    import time

    from repro_torch.core.morph import _block_until_ready

    side = torch.cuda.Stream(device=cuda)
    torch.cuda.synchronize()
    with torch.cuda.stream(side):
        torch.cuda._sleep(1_000_000_000)
    x = torch.ones(4, device=cuda) * 2
    t0 = time.perf_counter()
    _block_until_ready({"x": (x,)})
    waited = time.perf_counter() - t0
    busy = not side.query()
    side.synchronize()
    assert busy, "the side stream finished first: the spin was too short"
    assert waited < 0.1, waited
    assert float(x.sum()) == 8.0


def test_full_width_dense_autoscale_lifecycle_on_card(cuda):
    """TinyLlama at full width, cut to 4 layers (an exit at 2), f32,
    fused, K = 2 warmed: the autoscaler adopts K = 4 off-thread, retires a
    unit to fit the budget, never stalls or drops a build, and the greedy
    streams equal a fixed-mode run's token for token."""
    import threading

    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    from repro_torch.runtime.autoscale import (AutoscaleConfig,
                                               AutoscalePolicy, Autoscaler)
    from repro_torch.runtime.serving import ServingEngine, poisson_trace
    from repro_torch.runtime.speculative import SpecConfig

    cfg = get_config("tinyllama-1.1b")
    cfg = cfg.scaled(elastic=dataclasses.replace(cfg.elastic,
                                                 exit_layers=(2,)),
                     n_layers=4, dtype="float32")
    params = init_params(cfg, seed=0, device=cuda)

    def engine():
        eng = ServingEngine(params, cfg, batch_size=4, cache_capacity=128,
                            prefill_threshold=8, fused=True,
                            speculative=SpecConfig(ks=(2,),
                                                   min_accept_rate=0.0),
                            device=cuda)
        eng.warmup()
        return eng

    def trace():
        return poisson_trace(8, 1e6, seed=6, vocab=cfg.vocab_size,
                             prompt_len=(1, 16), new_tokens=(16, 24))

    base = engine()
    reqs = trace()
    base.run(reqs[:4])
    base.run(reqs[4:])
    want = {r.rid: r.generated for r in base.completed}
    eng = engine()
    budget = eng.compiles_after_warmup + 1
    asc = Autoscaler(AutoscaleConfig(interval_ticks=1, table_budget=budget,
                                     spec_ks=(4,), pop_size=8,
                                     generations=2)).bind(eng)
    policy = AutoscalePolicy(cfg, eng.ctrl, autoscaler=asc, batch_size=4,
                             cache_capacity=128, metrics=eng.metrics)
    try:
        reqs = trace()
        eng.run(reqs[:4], policy=policy, budget_fn=lambda t: 0.5)
        _await_unit(asc)
        eng.run(reqs[4:], policy=policy, budget_fn=lambda t: 0.5)
    finally:
        asc.close()
    st = asc.stats
    assert st["published"] >= 1 and st["retired"] >= 1, st
    assert st["tick_stalls"] == 0 and st["dropped"] == 0, st
    assert eng.ctrl.compile_table_size <= budget
    assert eng.ctrl.stats["compiles"] == \
        eng.compiles_after_warmup + st["published_keys"]
    assert threading.get_ident() not in asc.worker_idents
    assert {r.rid: r.generated for r in eng.completed} == want


def test_mesh_world_one_nccl_engine_matches_local(cuda):
    """``MeshExecutor`` at world size 1 (NCCL: one rank, one card) serves
    the fused smoke engine's tokens, launch for launch."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_serve_mesh
    from repro_torch.models.model import init_params
    from repro_torch.runtime.serving import (LocalExecutor, MeshExecutor,
                                             ServingEngine, poisson_trace)

    cfg = smoke_config("tinyllama-1.1b")
    params = init_params(cfg, seed=0, device=cuda)

    def run(executor):
        eng = ServingEngine(params, cfg, batch_size=4, cache_capacity=64,
                            prefill_threshold=4, fused=True,
                            executor=executor, device=cuda)
        eng.warmup()
        FD.reset_launch_count()
        eng.run(poisson_trace(8, 1e6, seed=3, vocab=cfg.vocab_size,
                              prompt_len=(1, 8), new_tokens=(4, 12)))
        return ({r.rid: r.generated for r in eng.completed},
                FD.launch_count())

    assert not dist.is_initialized()
    try:
        mesh = make_serve_mesh(1, 1, device="cuda")
        assert dist.get_backend() == "nccl"
        got = run(MeshExecutor(mesh))
    finally:
        dist.destroy_process_group()
    assert got == run(LocalExecutor("cuda"))
    assert got[1] > 0


@pytest.mark.parametrize("rank", [0, 1])
def test_kernels_at_tinyllama_tp2_shard_shapes_match_plain(cuda, rank):
    """B1 over a tp = 2 rank's projections of TinyLlama (16 / 2 heads of
    64, d_ff 2816: ``wo`` and ``down`` contract 1024 and 2816 rows) and B2
    at its attention, with the rank's localized width gates (rank 1 runs
    zero columns for the slots at widths 0.25 and 0.5)."""
    from repro_torch.configs import get_config
    from repro_torch.core import elastic
    from repro_torch.parallel import sharding as SH
    from repro_torch.parallel.tensor_parallel import localize

    full = get_config("tinyllama-1.1b")
    sh = SH.plan_serve_shard(full, {"data": 1, "model": 2}, n_slots=4,
                             coord={"data": 0, "model": rank})
    cfg = dataclasses.replace(sh.cfg, dtype="bfloat16")
    act = localize(elastic.active_widths_batch(full, [0.25, 0.5, 1.0, 0.5],
                                               device=cuda), sh)
    g = torch.Generator(device=cuda).manual_seed(5)
    dm, H, KV, hd, B = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, \
        cfg.head_dim, 4
    x = torch.randn(B, 1, dm, generator=g, device=cuda).to(torch.bfloat16)
    for K, N, an, ak in ((dm, H * hd, act["q_dim"], None),
                         (dm, KV * hd, act["kv_dim"], None),
                         (H * hd, dm, None, act["q_dim"]),
                         (dm, cfg.d_ff, act["d_ff"], None),
                         (cfg.d_ff, dm, None, act["d_ff"])):
        xi = torch.randn(B, 1, K, generator=g, device=cuda).to(
            torch.bfloat16)
        w = torch.randn(K, N, generator=g, device=cuda) / np.sqrt(K)
        _close(MM.morph_matmul(xi, w, an, ak),
               MM.morph_matmul_plain(xi, w, an, ak), torch.bfloat16)
    params = {n: torch.randn(*s, generator=g, device=cuda) / np.sqrt(s[0])
              for n, s in (("wq", (dm, H * hd)), ("wk", (dm, KV * hd)),
                           ("wv", (dm, KV * hd)), ("wo", (H * hd, dm)))}
    S = 256
    cache = {k: torch.randn(B, S, KV, hd, generator=g, device=cuda).to(
        torch.bfloat16) for k in ("k", "v")}
    pos = torch.tensor([0, 17, 130, 255], dtype=torch.int32, device=cuda)
    c_k = {n: t.clone() for n, t in cache.items()}
    c_p = {n: t.clone() for n, t in cache.items()}
    o_k, _ = FD.fused_decode_step(params, x, c_k, pos, cfg, active=act)
    o_p, _ = FD.fused_decode_plain(params, x, c_p, pos, cfg, act["q_dim"],
                                   act["kv_dim"])
    torch.cuda.synchronize()
    _close(o_k, o_p, torch.bfloat16)
    for n in cache:
        _close(c_k[n], c_p[n], torch.bfloat16)
