"""The port's sharding rules against the JAX package's, in one process.

``param_specs`` leaf for leaf against ``repro.parallel.sharding`` on an
abstract (2, 4) ``("data", "model")`` mesh (no devices needed) for every
family's smoke config and the ``train``, ``serve_tp`` and ``serve_2d``
policies; ``decode_specs`` / ``verify_specs`` and ``serve_policy`` likewise;
the shard -> unshard round trip; the serving shard plan (the KV heads a rank
holds, the experts and the cross-attention's leaves, the local width
gates); ``serve_2d``'s pieces against the ``serve_tp`` shard they gather
into; ``bubble_fraction``; and, at world size 1
over gloo, ``MeshExecutor`` against ``LocalExecutor`` token for token.
"""
import jax
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import smoke_config as jax_smoke_config
from repro.models.model import init_params as jax_init_params
from repro.parallel import sharding as JSH
from repro.parallel.pipeline_parallel import bubble_fraction as jax_bubble
from repro_torch.configs import get_config, list_archs, smoke_config
from repro_torch.models.model import init_params
from repro_torch.parallel import sharding as SH
from repro_torch.parallel.pipeline_parallel import bubble_fraction
from repro_torch.parallel.tensor_parallel import localize
from torch_threads import one_thread  # noqa: E402,F401  (autouse)

MESH = {"data": 2, "model": 4}
POLICIES = ("train", "serve_tp", "serve_2d")


def _jax_mesh():
    return AbstractMesh((2, 4), ("data", "model"))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("arch", list_archs())
def test_param_specs_match_jax(arch):
    cfg = smoke_config(arch)
    port = init_params(cfg, seed=0, device="cpu")
    jcfg = jax_smoke_config(arch)
    shapes = jax.eval_shape(lambda: jax_init_params(jax.random.PRNGKey(0),
                                                    jcfg))
    for policy in POLICIES:
        want = _flat(jax.tree_util.tree_map(
            tuple, JSH.param_specs(shapes, jcfg, _jax_mesh(), policy),
            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)))
        got = _flat(SH.param_specs(port, cfg, MESH, policy))
        assert got == want, (arch, policy)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "mamba2-370m",
                                  "jamba-v0.1-52b"])
def test_decode_and_verify_specs_match_jax(arch):
    cfg, jcfg = smoke_config(arch), jax_smoke_config(arch)
    for fn, jfn in ((SH.decode_specs, JSH.decode_specs),
                    (SH.verify_specs, JSH.verify_specs)):
        for policy in ("serve_tp", "serve_2d"):
            for batch in (None, 3, 4):
                want = {k: tuple(v) for k, v in
                        jfn(jcfg, _jax_mesh(), policy, batch).items()}
                assert fn(cfg, MESH, policy, batch) == want


def test_serve_policy_matches_jax():
    from repro.configs import get_config as jax_get_config

    for arch in list_archs():
        for tp in (1, 2, 16):
            assert SH.serve_policy(get_config(arch), tp) == \
                JSH.serve_policy(jax_get_config(arch), tp), (arch, tp)


@pytest.mark.parametrize("policy", POLICIES)
def test_shard_unshard_round_trip(policy):
    cfg = smoke_config("jamba-v0.1-52b")  # attention, SSM and MoE leaves
    params = init_params(cfg, seed=0, device="cpu")
    specs = SH.param_specs(params, cfg, MESH, policy)
    back = SH.unshard_params(
        lambda c: SH.shard_params(params, specs, MESH, coord=c), specs, MESH)
    flat, fb = _flat(params), _flat(back)
    assert flat.keys() == fb.keys()
    for k in flat:
        assert torch.equal(flat[k], fb[k]), k
    # a split leaf is a quarter (model) or an eighth (both axes) per rank
    piece = _flat(SH.shard_params(params, specs, MESH,
                                  coord={"data": 1, "model": 3}))
    wq = "stack/pos0/attn/wq" if "stack/pos0/attn/wq" in piece \
        else next(k for k in piece if k.endswith("attn/wq"))
    full = flat[wq].shape
    div = 8 if policy != "serve_tp" else 4
    assert piece[wq].numel() * div == flat[wq].numel(), (wq, full)


def test_serve_params_cut_as_specs_where_layouts_agree():
    """tp = 2 (KV heads split): every tinyllama leaf is the serve_tp spec's
    slice; mamba2's differ only on the per-head vectors the port holds
    sliced (JAX replicates them)."""
    mesh = {"data": 1, "model": 2}
    for arch, differ in (("tinyllama-1.1b", set()),
                         ("mamba2-370m", {"w_dt", "A_log", "D", "dt_bias"})):
        cfg = smoke_config(arch)
        params = init_params(cfg, seed=0, device="cpu")
        specs = SH.param_specs(params, cfg, mesh, "serve_tp")
        for r in range(2):
            coord = {"data": 0, "model": r}
            shard = SH.plan_serve_shard(cfg, mesh, n_slots=3, coord=coord)
            got = _flat(SH.shard_serve_params(params, shard, cfg))
            want = _flat(SH.shard_params(params, specs, mesh, coord=coord))
            for k in got:
                if k.split("/")[-1] in differ:
                    nh = shard.ssm_heads
                    full = _flat(params)[k]
                    assert torch.equal(got[k], full.narrow(
                        full.dim() - 1, nh[0], nh[1])), k
                else:
                    assert torch.equal(got[k], want[k]), (arch, k)


def test_kv_heads_replicate_when_tp_exceeds_kv():
    """The smoke config's 2 KV heads at tp = 4 (``decode_specs`` pins
    ``decode_kv`` replicated): rank r holds query head r and the KV head
    r // 2 it reads; at tp = 2 the KV heads split."""
    cfg = smoke_config("tinyllama-1.1b")
    assert SH.decode_specs(cfg, {"data": 1, "model": 4},
                           "serve_tp")["decode_kv"][2] is None
    for r in range(4):
        sh = SH.plan_serve_shard(cfg, {"data": 1, "model": 4}, n_slots=3,
                                 coord={"data": 0, "model": r})
        assert sh.heads == (r, 1) and sh.kv_heads == (r // 2, 1)
        assert (sh.cfg.n_heads, sh.cfg.n_kv_heads) == (1, 1)
    sh = SH.plan_serve_shard(cfg, {"data": 1, "model": 2}, n_slots=3,
                             coord={"data": 0, "model": 1})
    assert sh.kv_heads == (1, 1) and sh.cfg.d_ff == cfg.d_ff // 2
    bad = cfg.scaled(n_heads=6, n_kv_heads=3)
    with pytest.raises(ValueError, match="KV heads"):
        SH.plan_serve_shard(bad, {"data": 1, "model": 2}, n_slots=3,
                            coord={"data": 0, "model": 0})


def test_slots_split_over_data_only_when_dense_and_divisible():
    cfg = smoke_config("tinyllama-1.1b")
    for n, paged, split in ((4, False, True), (3, False, False),
                            (4, True, False)):
        sh = SH.plan_serve_shard(cfg, {"data": 2, "model": 2}, n_slots=n,
                                 paged=paged, coord={"data": 1, "model": 0})
        assert sh.split_slots == split
        assert sh.slots == ((2, 2) if split else (0, n))


def test_serve_cache_specs_split_by_kv_head_not_by_sequence():
    """The port's cache layout: KV heads on ``model`` (the reference puts
    the KV sequence dim there under serve_tp), slots on ``data`` for a
    dense cache whose slot count divides."""
    cfg = smoke_config("tinyllama-1.1b")
    mesh = {"data": 2, "model": 2}
    dense = SH.serve_cache_specs(cfg, mesh, n_slots=4)
    assert dense["k"] == (None, "data", None, "model", None)
    assert dense["pos"] == ("data",)
    assert SH.serve_cache_specs(cfg, mesh, n_slots=3)["k"][1] is None
    paged = SH.serve_cache_specs(cfg, mesh, n_slots=4, paged=True)
    assert paged["k"] == (None, None, None, "model", None)
    assert paged["pos"] == (None,)
    assert dense["state"] == (None, "data", "model", None, None)


def test_moe_cross_and_frontend_leaves_cut_as_specs():
    """The families a tp-only split now serves: granite's 4 experts at
    tp = 2 (2 whole experts a rank), 6 experts at tp = 4 (a quarter of each
    expert's columns), whisper's encoder and cross-attention, internvl's
    frontend projection (replicated): every leaf is the ``serve_tp``
    spec's slice (but the K/V projections of a KV head replicated at
    tp = 4); the encoder K/V cache splits by KV head."""
    cases = (("granite-moe-1b-a400m", {}, 2), ("granite-moe-1b-a400m",
                                               dict(n_experts=6), 4),
             ("whisper-base", {}, 2), ("internvl2-2b", {}, 2))
    for arch, over, tp in cases:
        cfg = smoke_config(arch).scaled(**over)
        params = init_params(cfg, seed=0, device="cpu")
        mesh = {"data": 1, "model": tp}
        specs = SH.param_specs(params, cfg, mesh, "serve_tp")
        for r in range(tp):
            coord = {"data": 0, "model": r}
            shard = SH.plan_serve_shard(cfg, mesh, n_slots=3, coord=coord)
            got = _flat(SH.shard_serve_params(params, shard, cfg))
            want = _flat(SH.shard_params(params, specs, mesh, coord=coord))
            for k in got:
                if cfg.n_kv_heads % tp and k.split("/")[-1] in ("wk", "wv"):
                    continue  # the KV head a rank reads, replicated
                assert torch.equal(got[k], want[k]), (arch, tp, k)
        if cfg.n_experts:
            ep = cfg.n_experts % tp == 0
            assert shard.experts == ((tp - 1) * cfg.n_experts // tp,
                                     cfg.n_experts // tp) if ep \
                else shard.experts == (0, cfg.n_experts)
            assert shard.cfg.moe_d_ff == (cfg.moe_d_ff if ep
                                          else cfg.moe_d_ff // tp)
            assert shard.cfg.n_experts == cfg.n_experts  # routing: global
    specs = SH.serve_cache_specs(smoke_config("whisper-base"),
                                 {"data": 2, "model": 2}, n_slots=4)
    assert specs["cross_k"] == (None, "data", "model", None, None)


def test_serve_2d_pieces_gather_into_the_serve_tp_shard():
    """``serve_2d`` at (2, 2): each rank holds ``param_specs(...,
    "serve_2d")``'s cut; concatenating the data ranks' pieces on the
    recipe's dim and cutting the replicated dims the recipe names gives
    the ``serve_tp`` shard, leaf for leaf. KV heads fewer than tp need a
    gather over ``model`` too, and are refused."""
    mesh = {"data": 2, "model": 2}
    for arch in ("tinyllama-1.1b", "mamba2-370m", "granite-moe-1b-a400m",
                 "whisper-base"):
        _serve_2d_pieces(arch, mesh)
    cfg = smoke_config("tinyllama-1.1b")
    shard = SH.plan_serve_shard(cfg, {"data": 2, "model": 4}, n_slots=4,
                                coord={"data": 0, "model": 0})
    with pytest.raises(ValueError, match="KV heads"):
        SH.serve_2d_plan(init_params(cfg, seed=0, device="cpu"), shard, cfg,
                         {"data": 2, "model": 4})


def _serve_2d_pieces(arch, mesh):
    cfg = smoke_config(arch)
    params = init_params(cfg, seed=0, device="cpu")
    for r in range(2):
        shard = SH.plan_serve_shard(cfg, mesh, n_slots=4,
                                    coord={"data": 0, "model": r})
        specs, recipes = SH.serve_2d_plan(params, shard, cfg, mesh)
        held = [_flat(SH.shard_params(params, specs, mesh,
                                      coord={"data": d, "model": r}))
                for d in range(2)]
        want = _flat(SH.shard_serve_params(params, shard, cfg))
        for k, rec in _flat(recipes).items():
            t = (held[0][k] if rec.data_dim is None else
                 torch.cat([h[k] for h in held], dim=rec.data_dim))
            for dim, (start, size) in rec.after.items():
                t = t.narrow(dim, start, size)
            assert tuple(t.shape) == rec.shape, k
            assert torch.equal(t, want[k]), (arch, r, k)


def test_local_gates_clamp_global_prefix_widths():
    """A shard holding columns [s, s + n) runs clamp(a - s, 0, n). tp = 4
    over 4 / 2 heads of 16: ranks 0 and 1 read KV head 0, ranks 2 and 3
    KV head 1, which width 0.5 leaves off."""
    cfg = smoke_config("tinyllama-1.1b")  # q_dim 64, kv_dim 32, d_ff 128
    from repro_torch.core import elastic

    active = elastic.active_widths_batch(cfg, [0.5, 1.0, 0.5],
                                         device="cpu")
    want = {0: {"q_dim": [16, 16, 16], "kv_dim": [16, 16, 16],
                "d_ff": [32, 32, 32]},
            1: {"q_dim": [16, 16, 16], "kv_dim": [16, 16, 16],
                "d_ff": [32, 32, 32]},
            2: {"q_dim": [0, 16, 0], "kv_dim": [0, 16, 0],
                "d_ff": [0, 32, 0]},
            3: {"q_dim": [0, 16, 0], "kv_dim": [0, 16, 0],
                "d_ff": [0, 32, 0]}}
    for r in range(4):
        sh = SH.plan_serve_shard(cfg, {"data": 1, "model": 4}, n_slots=3,
                                 coord={"data": 0, "model": r})
        loc = localize(active, sh)
        assert {k: v.tolist() for k, v in loc.items()} == want[r], r


def test_bubble_fraction():
    assert abs(bubble_fraction(4, 4) - 3 / 7) < 1e-12
    for m, s in ((1, 1), (8, 2), (3, 5)):
        assert bubble_fraction(m, s) == jax_bubble(m, s)


def test_mesh_executor_at_world_one_matches_local():
    """One rank over gloo: the mesh path (shard plan, wrapped steps, rank 0
    agreement) serves the local path's tokens, and a mesh larger than the
    world is refused."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_debug_mesh, make_serve_mesh
    from repro_torch.runtime.serving import (LocalExecutor, MeshExecutor,
                                             Request, ServingEngine)

    cfg = smoke_config("tinyllama-1.1b")
    params = init_params(cfg, seed=0, device="cpu")

    def run(executor):
        eng = ServingEngine(params, cfg, batch_size=3, cache_capacity=32,
                            prefill_threshold=3, executor=executor,
                            device="cpu")
        eng.warmup()
        for i in range(5):
            eng.submit(Request(rid=i, prompt=tuple(range(1, 2 + i)),
                               max_new_tokens=4))
        while eng.queue or eng.n_active:
            eng.step()
        return {r.rid: r.generated for r in eng.completed}

    assert not dist.is_initialized()
    try:
        mesh = make_serve_mesh(1, 1, device="cpu")
        assert run(MeshExecutor(mesh, device="cpu")) == \
            run(LocalExecutor("cpu"))
        with pytest.raises(ValueError, match="needs 8 ranks"):
            make_debug_mesh(device="cpu")
        with pytest.raises(ValueError, match=">= 1"):
            make_serve_mesh(0, 1)
    finally:
        dist.destroy_process_group()
