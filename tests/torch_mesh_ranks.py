"""Rank programs for ``tests/test_torch_mesh.py`` and
``tests/test_torch_mesh_serving.py``: the port's mesh serving, chaos drill,
resharding and pipelining, the MoE, encoder-decoder and frontend families,
the autoscaler over a mesh and ``serve_2d``, run as gloo ranks on the CPU.

    PYTHONPATH=src python tests/torch_mesh_ranks.py RUN DIR

starts the 4 ranks of ``RUN`` (``serve``, ``chaos`` or ``mesh_serving``)
with ``repro_torch.launch.mesh.spawn_ranks``, rendezvousing through a fresh
``DIR/RUN.store``; they read their inputs from ``DIR`` and rank 0 writes
``DIR/RUN.json``. Nothing here imports JAX: the test computes the JAX side
in its own process.
"""
from __future__ import annotations

import json
import os
import sys

import torch

FAIL_SITES = ("verify", "paged_decode", "prefill")


def streams(eng):
    return {str(r.rid): list(r.generated) for r in eng.completed}


def drive(eng, cfg):
    """``tests/test_serving_mesh.py``'s trace: mixed widths and a depth
    switch mid-trace, prompt lengths 1-5 (threshold 4: both the token feed
    and the prefill admission run)."""
    from repro_torch.runtime.serving import Request

    modes = eng.ctrl.modes
    full = modes[-1]
    widths = [m for m in modes if m.depth == full.depth]
    shallow = [m for m in modes if m.depth != full.depth]
    rid = 0
    for m in [widths[-1], widths[0], shallow[-1], widths[-1]]:
        eng.set_admission_mode(m)
        plen = 1 + rid % 5
        eng.submit(Request(
            rid=rid, prompt=tuple(1 + (rid * 7 + j) % (cfg.vocab_size - 1)
                                  for j in range(plen)),
            max_new_tokens=5,
            slo_class="interactive" if rid % 2 else "batch"))
        rid += 1
        eng.step()
    while eng.queue or eng.n_active:
        eng.step()
    return streams(eng)


def chaos_trace(cfg):
    """``tests/test_chaos.py``'s ``_trace(6)``: every arrival at t ~ 0."""
    from repro_torch.runtime.serving import poisson_trace

    return poisson_trace(6, rate_per_s=1e6, seed=5, vocab=cfg.vocab_size,
                         prompt_len=(1, 9), interactive_frac=0.3)


def chaos_engine(params, cfg, executor):
    from repro_torch.models.paged import PagedLayout
    from repro_torch.runtime.serving import ServingEngine
    from repro_torch.runtime.speculative import SpecConfig

    eng = ServingEngine(params, cfg, batch_size=3, cache_capacity=32,
                        prefill_threshold=4, device="cpu",
                        speculative=SpecConfig(ks=(2,)),
                        paged=PagedLayout(page_size=4), executor=executor)
    eng.warmup()
    return eng


def _shapes(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_shapes(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = list(v.shape)
    return out


def _same_on_every_rank(obj):
    import torch.distributed as dist

    got = [None] * dist.get_world_size()
    dist.all_gather_object(got, obj)
    return all(g == got[0] for g in got)


def _engine(params, cfg, mesh, batch, policy=None, **kw):
    from repro_torch.runtime.serving import MeshExecutor, ServingEngine

    eng = ServingEngine(params, cfg, batch_size=batch, cache_capacity=32,
                        prefill_threshold=4, device="cpu",
                        executor=MeshExecutor(mesh, policy=policy,
                                              device="cpu"), **kw)
    eng.warmup()
    return eng


def serve(rank, world, d):
    """(2, 2) over tinyllama and mamba2 (3 slots: replicated over data),
    tinyllama with 4 slots (split over data; plain, then fused with a
    (2, 2) token tree and K = 2 built) and at (1, 4) (KV = 2 < tp: each
    rank holds the KV head its query heads read), then ``compressed_psum``
    with one worker per rank."""
    import torch.distributed as dist

    from repro_torch.configs import smoke_config
    from repro_torch.launch.mesh import make_serve_mesh

    torch.set_num_threads(1)
    res = {}
    mesh = make_serve_mesh(2, 2, device="cpu")
    for arch in ("tinyllama-1.1b", "mamba2-370m"):
        cfg = smoke_config(arch)
        params = torch.load(os.path.join(d, f"{arch}.pt"))
        eng = _engine(params, cfg, mesh, 3)
        traces0 = eng.ctrl.trace_counter["n"]
        out = drive(eng, cfg)
        res[arch] = dict(
            streams=out, prefills=eng.prefills,
            compiles_after_warmup=eng.compiles_after_warmup,
            compiles=eng.ctrl.stats["compiles"],
            retraces=eng.ctrl.trace_counter["n"] - traces0,
            depths=len({m.depth for m in eng.ctrl.modes}),
            same_on_every_rank=_same_on_every_rank(out),
            params=_shapes(eng.params), cache=_shapes(
                next(iter(eng.groups.values())).cache))
    cfg = smoke_config("tinyllama-1.1b")
    params = torch.load(os.path.join(d, "tinyllama-1.1b.pt"))
    eng = _engine(params, cfg, mesh, 4)
    out = drive(eng, cfg)
    res["tinyllama-1.1b slots4"] = dict(
        streams=out, same_on_every_rank=_same_on_every_rank(out),
        split_slots=eng.executor.shard.split_slots,
        cache=_shapes(next(iter(eng.groups.values())).cache))
    from repro_torch.runtime.speculative import SpecConfig

    eng = _engine(params, cfg, mesh, 4, fused=True,
                  speculative=SpecConfig(ks=(2,), trees=((2, 2),)))
    out = drive(eng, cfg)
    res["tinyllama-1.1b slots4 fused tree"] = dict(
        streams=out, same_on_every_rank=_same_on_every_rank(out),
        tree_launches=eng.spec_tree_launches)
    mesh14 = make_serve_mesh(1, 4, device="cpu")
    eng = _engine(params, cfg, mesh14, 3, fused=True)
    out = drive(eng, cfg)
    res["tinyllama-1.1b 1x4 fused"] = dict(
        streams=out, same_on_every_rank=_same_on_every_rank(out),
        kv_heads=list(eng.executor.shard.kv_heads),
        params=_shapes(eng.params))
    # compressed_psum over the 4 ranks, one worker's gradients each
    from repro_torch.runtime.compression import compressed_psum

    inp = torch.load(os.path.join(d, "psum.pt"))
    red, err = compressed_psum({k: v[rank] for k, v in inp["g"].items()},
                               {k: v[rank] for k, v in inp["e"].items()})
    got = _gathered((red, err))
    if rank == 0:
        torch.save(got, os.path.join(d, "psum_out.pt"))
        with open(os.path.join(d, "serve.json"), "w") as f:
            json.dump(res, f)
    dist.barrier()


def chaos(rank, world, d):
    """``tests/test_chaos.py``'s mesh drill at (2, 2), then
    ``elastic_reshard`` (2, 2) -> (1, 4) -> (2, 2), then ``pipeline_apply``
    over 4 stages against sequential application."""
    import torch.distributed as dist

    from repro_torch.configs import smoke_config
    from repro_torch.launch.mesh import make_serve_mesh
    from repro_torch.parallel import sharding as SH
    from repro_torch.runtime.fault_tolerance import (ExecutorSupervisor,
                                                     FailurePlan,
                                                     elastic_reshard)
    from repro_torch.runtime.serving import MeshExecutor

    torch.set_num_threads(1)
    cfg = smoke_config("tinyllama-1.1b")
    params = torch.load(os.path.join(d, "tinyllama-1.1b.pt"))
    mesh = make_serve_mesh(2, 2, device="cpu")

    def factory():
        return chaos_engine(params, cfg, MeshExecutor(mesh, device="cpu"))

    counter = FailurePlan()
    sup0 = ExecutorSupervisor(factory, failure_plan=counter)
    sup0.run_trace(chaos_trace(cfg))
    eng_a = sup0.engine
    ref = streams(eng_a)
    totals = dict(counter.site_counts)
    plan = FailurePlan(at_sites=tuple((s, 1) for s in FAIL_SITES))
    engines = [eng_a, factory()]
    idx = [0]

    def pingpong():
        idx[0] ^= 1
        return engines[idx[0]]

    sup = ExecutorSupervisor(pingpong, failure_plan=plan, max_failovers=3)
    summary = sup.run_trace(chaos_trace(cfg))
    sup.engine.check_paged_invariants()
    out = streams(sup.engine)
    res = dict(ref=ref, out=out, totals=totals,
               failovers=summary["failovers"],
               fired=sorted(map(list, plan.fired_sites)),
               same_on_every_rank=_same_on_every_rank(out))

    # reshard: the train policy splits both mesh axes
    mesh14 = make_serve_mesh(1, 4, device="cpu")
    s22 = SH.param_specs(params, cfg, mesh, "train")
    s14 = SH.param_specs(params, cfg, mesh14, "train")
    local = SH.shard_params(params, s22, mesh)
    moved = elastic_reshard(local, (mesh, s22), (mesh14, s14))
    back = elastic_reshard(moved, (mesh14, s14), (mesh, s22))
    want = SH.shard_params(params, s14, mesh14)

    def equal(a, b):
        if isinstance(a, dict):
            return all(equal(a[k], b[k]) for k in a)
        return a.shape == b.shape and bool(torch.equal(a, b))

    ok = equal(moved, want) and equal(back, local)
    res["reshard_ok"] = bool(min(_gathered(ok)))
    res["pipeline"] = pipeline(rank, world, d)
    if rank == 0:
        with open(os.path.join(d, "chaos.json"), "w") as f:
            json.dump(res, f)
    dist.barrier()


def _gathered(obj):
    import torch.distributed as dist

    got = [None] * dist.get_world_size()
    dist.all_gather_object(got, obj)
    return got


def pipeline(rank, world, d):
    """``tests/test_pipeline_parallel.py``'s case: 4 stages of
    ``relu(h @ w)``, 4 microbatches; the largest error on any rank."""
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.parallel.pipeline_parallel import (bubble_fraction,
                                                        pipeline_apply)

    data = torch.load(os.path.join(d, "pipeline.pt"))
    ws, x = data["ws"], data["x"]
    mesh = DeviceMesh("cpu", torch.arange(world).reshape(world, 1),
                      mesh_dim_names=("pod", "model"))

    def fn(w, h):
        return torch.relu(h @ w)

    y = pipeline_apply(ws[rank:rank + 1], x, fn, mesh, axis="pod",
                       n_micro=4)
    h = x
    for s in range(world):
        h = fn(ws[s], h)
    return dict(max_abs_err=max(_gathered(float((y - h).abs().max()))),
                bubble=bubble_fraction(4, world))


FAMILIES = ("granite-moe-1b-a400m", "jamba-v0.1-52b", "whisper-base",
            "internvl2-2b")
# a granite whose 6 experts do not split over tp = 4: every rank holds a
# quarter of each expert's columns
GRANITE6 = dict(n_experts=6)


def family_config(name):
    from repro_torch.configs import smoke_config

    if name == "granite6":
        return smoke_config("granite-moe-1b-a400m").scaled(**GRANITE6)
    return smoke_config(name)


def family_params(name, d):
    from repro_torch.models.model import init_params

    if name == "granite6":
        return init_params(family_config(name), seed=0, device="cpu")
    return torch.load(os.path.join(d, f"{name}.pt"))


def logged_drive(eng, cfg):
    """``drive``, every tick's logits kept (the vocabulary's columns):
    (streams, [logits of each sampling call])."""
    seen = []
    sample = eng._sample

    def keep(lg, keys):
        seen.append(lg[..., :cfg.vocab_size].float().clone())
        return sample(lg, keys)

    eng._sample = keep
    out = drive(eng, cfg)
    eng._sample = sample
    return out, seen


def prompt_pass(params, cfg, inputs):
    """A prompt pass with the frontend's operand (whisper's frames,
    internvl's patches) and two decode steps after it: the logits of all
    three, as one tensor (B, 3, V). Runs on the shard context it is called
    in."""
    from repro_torch.models.model import decode_step, prefill

    batch = {k: v for k, v in inputs.items() if k != "next"}
    lg, cache = prefill(params, batch, cfg, cache_extra=4, per_slot=True)
    out = [lg[:, -1:, :cfg.vocab_size]]
    for t in range(2):
        lg, cache = decode_step(params, cache, inputs["next"][:, t:t + 1],
                                cfg)
        out.append(lg[:, :, :cfg.vocab_size])
    return torch.cat(out, dim=1)


def mesh_serving(rank, world, d):
    """``families`` then ``autoscale`` on (2, 2) and (1, 4) meshes of the 4
    ranks; rank 0 writes ``DIR/mesh_serving.json`` and the families'
    logits to ``DIR/families_logits.pt``."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_serve_mesh

    torch.set_num_threads(1)
    mesh22 = make_serve_mesh(2, 2, device="cpu")
    mesh14 = make_serve_mesh(1, 4, device="cpu")
    fam, logits = families(d, mesh22, mesh14)
    res = {"families": fam, "autoscale": autoscale(d, mesh22)}
    if rank == 0:
        torch.save(logits, os.path.join(d, "families_logits.pt"))
        with open(os.path.join(d, "mesh_serving.json"), "w") as f:
            json.dump(res, f)
    dist.barrier()


def families(d, mesh22, mesh14):
    """The MoE (granite, jamba), encoder-decoder (whisper) and frontend
    (internvl) families under ``serve_tp``: ``drive`` at (2, 2) (4 slots,
    split over data; fused) and (1, 4) (3 slots; unfused), granite with 6
    experts at (1, 4) (columns, not experts, split), each tick's logits
    kept; then whisper's and internvl's prompt passes with frames and
    patches at tp = 2 (the (2, 2) mesh's model axis), two decode steps
    after each. Returns (results, logits)."""
    from repro_torch.parallel.tensor_parallel import shard_context
    from repro_torch.runtime.serving import MeshExecutor

    res, logits = {}, {}
    meshes = {"2x2": (mesh22, 4, True), "1x4": (mesh14, 3, False)}
    runs = [(a, m) for a in FAMILIES for m in meshes] + [("granite6", "1x4")]
    for arch, m in runs:
        mesh, batch, fused = meshes[m]
        cfg = family_config(arch)
        eng = _engine(family_params(arch, d), cfg, mesh, batch, fused=fused)
        out, seen = logged_drive(eng, cfg)
        sh = eng.executor.shard
        res[f"{arch} {m}"] = dict(
            streams=out, same_on_every_rank=_same_on_every_rank(out),
            experts=list(sh.experts), moe_ff=list(sh.moe_ff),
            params=_shapes(eng.params),
            cache=_shapes(next(iter(eng.groups.values())).cache))
        logits[f"{arch} {m}"] = seen
    inputs = torch.load(os.path.join(d, "frontend.pt"))
    mesh = meshes["2x2"][0]
    for arch in ("whisper-base", "internvl2-2b"):
        cfg = family_config(arch)
        ex = MeshExecutor(mesh, device="cpu").bind(cfg, 1, 32)
        p = ex.place_params(family_params(arch, d))
        with torch.no_grad(), shard_context(ex.comm):
            got = prompt_pass(p, ex.shard.cfg, inputs[arch])
        res[f"{arch} prompt"] = dict(
            same_on_every_rank=_same_on_every_rank(got.tolist()))
        logits[f"{arch} prompt"] = got
    return res, logits


def autoscale_traces():
    """``tests/test_autoscale.py``'s mesh lifecycle traces: a burst of 8
    arrivals at 200 / s, then 6 at 30 / s (rids from 100)."""
    from dataclasses import replace

    from repro_torch.runtime.serving import poisson_trace

    t1 = poisson_trace(8, 200.0, seed=1, new_tokens=(4, 6))
    t2 = [replace(r, rid=r.rid + 100)
          for r in poisson_trace(6, 30.0, seed=2, new_tokens=(4, 6))]
    return t1, t2


def autoscale_engine(params, cfg, executor):
    from repro_torch.runtime.serving import ServingEngine
    from repro_torch.runtime.speculative import SpecConfig

    eng = ServingEngine(params, cfg, batch_size=2, cache_capacity=32,
                        prefill_threshold=4, speculative=SpecConfig(ks=(2,)),
                        executor=executor, device="cpu")
    eng.warmup()
    return eng


def autoscaled_run(eng, cfg):
    """``tests/test_autoscale.py``'s mesh lifecycle on ``eng``: table budget
    warmup + 1, candidate K = 4, interval 1, population 8, 2 generations;
    the first trace, the builds awaited, the second. Returns the
    autoscaler (closed) and its result fields."""
    import threading

    from repro_torch.runtime.autoscale import (AutoscaleConfig,
                                               AutoscalePolicy, Autoscaler)

    budget = eng.compiles_after_warmup + 1
    asc = Autoscaler(AutoscaleConfig(interval_ticks=1, table_budget=budget,
                                     spec_ks=(4,), pop_size=8, generations=2,
                                     seed=0)).bind(eng)
    policy = AutoscalePolicy(cfg, eng.ctrl, autoscaler=asc,
                             batch_size=eng.batch_size, cache_capacity=32,
                             metrics=eng.metrics, executor=eng.executor)
    compiles0 = eng.ctrl.stats["compiles"]
    t1, t2 = autoscale_traces()
    eng.run(t1, policy=policy, budget_fn=lambda t: 0.5)
    built = asc.await_builds(120.0)
    eng.run(t2, policy=policy, budget_fn=lambda t: 0.5)
    asc.close()
    events = [[e["step"], e["event"], e["unit"]] for e in eng.metrics.events(
        "autoscale_events", ("step", "event", "unit", "generation",
                             "detail")) if e["event"] != "generation"]
    return dict(streams=streams(eng), stats=dict(asc.stats), built=built,
                budget=budget, table=eng.ctrl.compile_table_size,
                compiles=eng.ctrl.stats["compiles"], compiles0=compiles0,
                events=events,
                off_thread=bool(asc.worker_idents) and
                threading.get_ident() not in asc.worker_idents)


def autoscale(d, mesh):
    """The autoscaler over the (2, 2) ``mesh`` (``autoscaled_run``) beside
    the fixed-mode mesh run of the same traces; then ``serve_2d`` on it on
    tinyllama, mamba2 and granite (4 slots, fused; ``drive``): each rank's
    held leaves against ``param_specs(..., "serve_2d")``'s cut, and the
    tokens of ``serve_tp`` on the same mesh. Returns the results."""
    from repro_torch.configs import smoke_config
    from repro_torch.parallel import sharding as SH
    from repro_torch.runtime.serving import MeshExecutor

    cfg = smoke_config("tinyllama-1.1b")
    params = torch.load(os.path.join(d, "tinyllama-1.1b.pt"))
    base = autoscale_engine(params, cfg, MeshExecutor(mesh, device="cpu"))
    base.set_admission_mode(base.ctrl.modes[-1])
    for t in autoscale_traces():
        base.run(t)
    res = {"fixed": streams(base)}
    auto = autoscaled_run(autoscale_engine(
        params, cfg, MeshExecutor(mesh, device="cpu")), cfg)
    res["autoscaled"] = auto
    res["every_rank"] = _gathered({k: auto[k] for k in (
        "events", "stats", "compiles", "table", "off_thread", "streams")})
    sizes, coord = SH.axis_sizes(mesh), SH.mesh_coord(mesh)
    for arch in ("tinyllama-1.1b", "mamba2-370m", "granite-moe-1b-a400m"):
        acfg = smoke_config(arch)
        p = torch.load(os.path.join(d, f"{arch}.pt"))
        out = {}
        for policy in ("serve_tp", "serve_2d"):
            eng = _engine(p, acfg, mesh, 4, fused=True, policy=policy)
            out[policy] = drive(eng, acfg)
        specs = SH.param_specs(p, acfg, mesh, "serve_2d")
        held = {k: bool(torch.equal(v, SH.take(
            _at(p, k.split("/")), SH.spec_slices(
                _at(p, k.split("/")).shape, _at(specs, k.split("/")),
                sizes, coord))))
            for k, v in _leaves_by_path(eng.params).items()}
        s2d = eng.executor.comm.serve2d
        res[f"{arch} serve_2d"] = dict(
            streams=out["serve_2d"], serve_tp=out["serve_tp"],
            held_is_spec_cut=min(_gathered(all(held.values()))),
            n_leaves=len(held), gathers=s2d.gathers,
            held_elems=sum(v.numel() for v in
                           _leaves_by_path(eng.params).values()),
            full_elems=sum(v.numel() for v in _leaves_by_path(p).values()),
            same_on_every_rank=_same_on_every_rank(out["serve_2d"]))
    return res


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _leaves_by_path(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves_by_path(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


RUNS = {"serve": serve, "chaos": chaos, "mesh_serving": mesh_serving}


if __name__ == "__main__":
    from repro_torch.launch.mesh import spawn_ranks

    name, d = sys.argv[1], sys.argv[2]
    store = os.path.join(d, f"{name}.store")
    if os.path.exists(store):
        os.remove(store)
    spawn_ranks(RUNS[name], 4, (d,), device="cpu",
                init_method=f"file://{store}")
