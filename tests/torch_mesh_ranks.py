"""Rank programs for ``tests/test_torch_mesh.py``: the port's mesh serving,
chaos drill, resharding and pipelining, run as gloo ranks on the CPU.

    PYTHONPATH=src python tests/torch_mesh_ranks.py RUN DIR

starts the 4 ranks of ``RUN`` (``serve`` or ``chaos``) with
``repro_torch.launch.mesh.spawn_ranks``, rendezvousing through a fresh
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


def _engine(params, cfg, mesh, batch, **kw):
    from repro_torch.runtime.serving import MeshExecutor, ServingEngine

    eng = ServingEngine(params, cfg, batch_size=batch, cache_capacity=32,
                        prefill_threshold=4, device="cpu",
                        executor=MeshExecutor(mesh, device="cpu"), **kw)
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


RUNS = {"serve": serve, "chaos": chaos}


if __name__ == "__main__":
    from repro_torch.launch.mesh import spawn_ranks

    name, d = sys.argv[1], sys.argv[2]
    store = os.path.join(d, f"{name}.store")
    if os.path.exists(store):
        os.remove(store)
    spawn_ranks(RUNS[name], 4, (d,), device="cpu",
                init_method=f"file://{store}")
