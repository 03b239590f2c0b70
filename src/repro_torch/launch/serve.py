"""Serving entry point: continuous-batching engine with NeuroMorph reconfiguration.

Port of ``repro.launch.serve`` for the flags this slice supports. Drives
``repro_torch.runtime.serving.ServingEngine`` — request queue, per-step slot
admission, per-DEPTH slot groups with per-slot runtime widths — while
switching morph modes on the fly. Width switches change a tensor operand of
the same step; only distinct depths build separate steps, and nothing is
rebuilt after warmup (asserted and reported).

Two traffic shapes:
  * default: a fixed round of ``--batch`` x enough requests to generate
    ``--tokens`` tokens, cycling the admission mode every ``--switch-every``
    engine steps.
  * ``--budget-ms``: SLO-driven — the admission mode is chosen each tick as
    the widest mode whose predicted step latency fits the budget.

``--spec-k K`` turns on linear self-speculative decoding (shallow exits
draft K tokens, one full-depth pass verifies K+1 positions) and
``--spec-tree 2x2x1`` token-tree speculation (level l: every frontier node
gets that many sibling candidates; one full-depth pass verifies the whole
tree and commits the accepted root-to-leaf path); both print the
acceptance telemetry; ``--temperature`` / ``--top-k`` sample instead of
taking the argmax. ``--kv-page-size N`` serves from a block-paged KV cache
(N tokens per page; shared prompt prefixes reuse pages through the radix
cache), ``--kv-pages`` sizes its pool. ``--trace-out trace.json`` writes Chrome trace-event JSON
of every launch and request; ``--metrics-dump`` prints the metrics
registry. Runs on the card (``--device cuda``, the default) unless
``--device cpu`` is given.

Fault-tolerance drill: ``--fail-at site:occ[,site:occ...]`` injects
executor failures at launch boundaries (sites: decode, paged_decode,
verify, tree_verify, prefill) and ``--tick-timeout-s`` arms hung-tick
detection; either routes the drive loop through an ``ExecutorSupervisor``
that snapshots before every tick and rebuilds and replays on a failure
(recovery timings are printed per failover). A real CUDA fault is not
recovered in the process: it ends the run. ``--deadline-s`` gives every
request a TTL on the virtual serving clock; requests still queued past it
finish as ``expired``.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
      --batch 8 --tokens 256 --switch-every 16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-370m \
      --batch 8 --tokens 256 --spec-k 4
  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
      --smoke --device cpu --kv-page-size 4 --fused --spec-k 2
  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
      --batch 8 --tokens 256 --fused --spec-tree 2x2x1
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch granite-moe-1b-a400m --batch 8 --tokens 256 --fused
  PYTHONPATH=src python -m repro_torch.launch.serve --arch jamba-v0.1-52b \
      --smoke --device cpu --spec-k 2
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-base \
      --batch 8 --tokens 256 --fused
  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
      --smoke --device cpu --fail-at decode:2,prefill:1
  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
      --smoke --device cpu --spec-k 2 --budget-ms 500 --autoscale \
      --autoscale-interval 1 --autoscale-ks 4
  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
      --mesh 1x2 --device cuda --fused
  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
      --smoke --device cpu --mesh 1x2 --spec-k 2 --budget-ms 500 \
      --autoscale --autoscale-interval 1 --autoscale-ks 4

Online autoscaling: ``--autoscale`` (with ``--budget-ms``, whose SLO loop
hosts the autoscaler's tick) re-runs the NeuroForge MOGA every
``--autoscale-interval`` ticks over the live pool of steps (modes x draft
shapes x page buckets); frontier points are built and warmed on a
background thread (on a CUDA stream of its own) and published between
ticks, and cold ones are retired while the table exceeds
``--autoscale-table-budget``. The run asserts that every build after
warmup came through publication and that no serving tick stalled, and
prints the autoscaler's summary and front.

Mesh serving: ``--mesh DPxTP`` serves over a (data, model) mesh of
``DP * TP`` ranks (``runtime.serving.MeshExecutor``): the CLI starts its
own ranks (``torch.multiprocessing``), or runs as one rank under
``torchrun`` when ``WORLD_SIZE`` is set. Only rank 0 prints. The backend
follows from the layout (``launch.mesh``): NCCL with a card per rank, gloo
when ranks share one card and on the CPU. Every family serves under it,
and every other flag combines with it as without it: with ``--autoscale``
each rank runs its own autoscaler, and all of them build, publish and
retire the same units on the same tick (``runtime.autoscale``). The
weights split as ``sharding.serve_policy`` picks: ``serve_tp`` (over
``model``), or ``serve_2d`` (over ``data`` too) for a model whose bf16
weights exceed 8 GB a rank under ``serve_tp``.

Encoder-decoder (whisper) and frontend (internvl) models serve on the
token feed, as the reference's engine serves them: their requests carry no
frames or patches, so no prompt is prefilled and the cross-attention
reads the zeros of a fresh cache. ``--spec-k``, ``--spec-tree`` and
``--kv-page-size`` raise the engine's ``ValueError`` for them.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys
import zlib

from repro_torch.configs import get_config, smoke_config
from repro_torch.core import elastic
from repro_torch.device import resolve_device
from repro_torch.models.model import init_params
from repro_torch.models.paged import PagedLayout
from repro_torch.runtime.fault_tolerance import (ExecutorSupervisor,
                                                 FailurePlan)
from repro_torch.runtime.observability import Observability
from repro_torch.runtime.serving import (MeshExecutor, Request,
                                         ServingEngine, SLOPolicy)
from repro_torch.runtime.speculative import SpecConfig

FAILURE_SITES = ("decode", "paged_decode", "verify", "tree_verify", "prefill")


def _parse_mesh(spec: str):
    try:
        dp, tp = (int(x) for x in spec.lower().split("x"))
    except ValueError:
        raise SystemExit(f"--mesh wants DPxTP (e.g. 2x4), got {spec!r}")
    if dp < 1 or tp < 1:
        raise SystemExit(f"--mesh wants degrees >= 1, got {spec!r}")
    return dp, tp


def _mesh_rank(rank: int, world: int, argv):
    """One rank of a ``--mesh`` run started by ``main``."""
    main(argv)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4, help="batch slots per depth")
    ap.add_argument("--tokens", type=int, default=64,
                    help="total tokens to generate across all requests")
    ap.add_argument("--switch-every", type=int, default=16,
                    help="cycle admission mode every N engine steps")
    ap.add_argument("--budget-ms", type=float, default=0.0,
                    help="if > 0, use the SLO policy with this latency budget")
    ap.add_argument("--prefill-threshold", type=int, default=8,
                    help="prompts at least this long are consumed by one "
                         "prefill instead of token-by-token")
    ap.add_argument("--fused", action="store_true",
                    help="route attention layers through the fused decode "
                         "and verify kernels (no effect on SSM layers, "
                         "which have no fused path)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature (0 = greedy argmax); per-slot "
                         "keys keep sampled streams reproducible under slot "
                         "churn")
    ap.add_argument("--top-k", type=int, default=0,
                    help="top-k sampling truncation (0 = full vocab)")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="speculative decoding draft length K (0 = off): "
                         "shallow exits draft K tokens, one full-depth pass "
                         "verifies K+1 positions")
    ap.add_argument("--spec-draft-depth", type=int, default=0,
                    help="draft exit depth in layer groups (0 = deepest "
                         "exit shallower than each serving depth)")
    ap.add_argument("--spec-tree", default="",
                    help="token-tree speculative decoding branching "
                         "schedule, e.g. 2x2x1 (level l: every frontier "
                         "node gets that many sibling candidates); one "
                         "full-depth pass verifies the whole tree and "
                         "commits the accepted root-to-leaf path. May be "
                         "combined with --spec-k (the SLO policy switches "
                         "between the built shapes at runtime)")
    ap.add_argument("--kv-page-size", type=int, default=0,
                    help="block-paged KV cache: tokens per physical page "
                         "(0 = dense per-slot buffers). Must divide the "
                         "cache capacity, and the sliding window when the "
                         "arch uses one; shared prompt prefixes then reuse "
                         "physical pages through the radix cache")
    ap.add_argument("--kv-pages", type=int, default=0,
                    help="physical page-pool size (0 = worst case: every "
                         "slot at full length + scratch). Requires "
                         "--kv-page-size; undersizing trades admission "
                         "deferrals for memory")
    ap.add_argument("--deadline-s", type=float, default=0.0,
                    help="per-request TTL in seconds on the virtual serving "
                         "clock (0 = none): requests still queued past it "
                         "finish as 'expired' instead of occupying slots")
    ap.add_argument("--fail-at", default="",
                    help="inject executor failures: comma-separated "
                         "site:occurrence pairs, e.g. decode:3,verify:1 "
                         f"(sites: {', '.join(FAILURE_SITES)}); each kills "
                         "that site's Nth launch, and an ExecutorSupervisor "
                         "rebuilds from the pre-tick snapshot and replays")
    ap.add_argument("--tick-timeout-s", type=float, default=0.0,
                    help="if > 0, supervise ticks with a wall-time timeout: "
                         "a slower tick is treated as a hung executor, its "
                         "results discarded and the tick redone on a "
                         "rebuilt engine")
    ap.add_argument("--trace-out", default="",
                    help="write Chrome trace-event JSON to this path")
    ap.add_argument("--metrics-dump", action="store_true",
                    help="print the end-of-run metrics registry as "
                         "Prometheus exposition text plus a JSON snapshot")
    ap.add_argument("--autoscale", action="store_true",
                    help="online NeuroForge autoscaler: periodically re-run "
                         "the MOGA over the live pool of steps (modes x "
                         "draft shapes x page buckets) with telemetry-"
                         "blended objectives; frontier points are built on "
                         "a background thread and published between ticks. "
                         "Requires --budget-ms (the SLO loop hosts the "
                         "autoscale tick)")
    ap.add_argument("--autoscale-interval", type=int, default=8,
                    help="serving ticks between MOGA generations")
    ap.add_argument("--autoscale-table-budget", type=int, default=0,
                    help="step-table budget (live built steps); cold "
                         "unassigned units are retired while the table "
                         "exceeds it (0 = no eviction)")
    ap.add_argument("--autoscale-ks", default="",
                    help="comma-separated candidate draft lengths the "
                         "autoscaler may adopt beyond the warmed table, "
                         "e.g. 4,6")
    ap.add_argument("--autoscale-pop", type=int, default=16,
                    help="MOGA population per online generation")
    ap.add_argument("--autoscale-gens", type=int, default=4,
                    help="MOGA generations per online re-run")
    ap.add_argument("--autoscale-explore-modes", action="store_true",
                    help="let admission move across the front's modes "
                         "(default: a pinned mode, so adoption changes only "
                         "draft shapes and buckets and greedy streams stay "
                         "those of a fixed-mode run)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "PyTorch versions of the kernels)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh", default="",
                    help="serve over a DPxTP (data x model) mesh of ranks, "
                         "e.g. 1x2; started here, or one rank of a "
                         "torchrun launch when WORLD_SIZE is set")
    argv = list(sys.argv[1:] if argv is None else argv)
    args = ap.parse_args(argv)
    if args.mesh:
        dp, tp = _parse_mesh(args.mesh)
        if "WORLD_SIZE" not in os.environ:
            from repro_torch.launch.mesh import spawn_ranks

            spawn_ranks(_mesh_rank, dp * tp, (argv,), device=args.device)
            return 0
        from repro_torch.launch.mesh import make_serve_mesh

        mesh = make_serve_mesh(dp, tp, device=args.device)
        if int(os.environ.get("RANK", 0)) != 0:
            with contextlib.redirect_stdout(io.StringIO()):
                return _serve(args, ap, mesh)
        return _serve(args, ap, mesh)
    return _serve(args, ap, None)


def _serve(args, ap, mesh):

    failure_plan = None
    if args.fail_at:
        at_sites = []
        for part in args.fail_at.split(","):
            site, sep, occ = part.strip().partition(":")
            if site not in FAILURE_SITES or not sep or not occ.isdigit() \
                    or int(occ) < 1:
                ap.error(f"--fail-at wants site:occurrence pairs with sites "
                         f"in {FAILURE_SITES} and occurrence >= 1, got "
                         f"{part!r}")
            at_sites.append((site, int(occ)))
        failure_plan = FailurePlan(at_sites=tuple(at_sites))
    if args.batch < 1:
        ap.error(f"--batch must be >= 1, got {args.batch}")
    spec_trees = ()
    if args.spec_tree:
        try:
            branching = tuple(int(b) for b in
                              args.spec_tree.lower().split("x"))
        except ValueError:
            branching = ()
        if not branching or any(b < 1 for b in branching):
            ap.error(f"--spec-tree wants a branching schedule of levels "
                     f">= 1 like 2x2x1, got {args.spec_tree!r}")
        spec_trees = (branching,)
    device = resolve_device(args.device)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    params = init_params(cfg, seed=args.seed, device=device)
    modes = cfg.elastic.modes(cfg.n_groups)
    per_req = max(4, args.tokens // (2 * args.batch))
    n_requests = max(args.batch, (args.tokens + per_req - 1) // per_req)
    # drafted-window headroom: linear K or the deepest tree's level count
    capacity = per_req + 8 + max([args.spec_k] + [len(t) for t in spec_trees])
    paged = None
    if args.kv_pages and not args.kv_page_size:
        ap.error("--kv-pages requires --kv-page-size (a pool needs a page "
                 "geometry)")
    if args.kv_page_size:
        # round the derived capacity up to a page boundary so the layout
        # validates for any --tokens / --batch
        capacity += (-capacity) % args.kv_page_size
        paged = PagedLayout(page_size=args.kv_page_size,
                            n_pages=args.kv_pages or None)
        try:
            paged.validate(cfg, capacity)
        except ValueError as e:
            ap.error(str(e))
    speculative = None
    if args.spec_k > 0 or spec_trees:
        speculative = SpecConfig(ks=(args.spec_k,) if args.spec_k > 0 else (),
                                 trees=spec_trees,
                                 draft_depth=args.spec_draft_depth or None,
                                 top_k=args.top_k)
    # one Observability shared by every engine this run builds (failover
    # standbys included), so the trace and metrics cover the whole run
    obs = Observability(trace=bool(args.trace_out))

    def build_engine():
        executor = (MeshExecutor(mesh, device=device) if mesh is not None
                    else None)
        return ServingEngine(params, cfg, batch_size=args.batch,
                             cache_capacity=capacity, modes=modes,
                             prefill_threshold=args.prefill_threshold,
                             speculative=speculative,
                             temperature=args.temperature, top_k=args.top_k,
                             sample_seed=args.seed, paged=paged,
                             fused=args.fused, observability=obs,
                             executor=executor, device=device)

    engine = build_engine()
    paged_note = ""
    if paged is not None:
        pool = paged.pool_pages(cfg, args.batch, capacity)
        paged_note = f" kv=paged({args.kv_page_size} tok/page, {pool} pages)"
    mesh_note = f" mesh={args.mesh}" if mesh is not None else ""
    print(f"[serve] {cfg.name} on {device}{mesh_note}: "
          f"modes = {[m.name for m in modes]} "
          f"requests={n_requests} x {per_req} tokens, batch={args.batch}"
          f"{paged_note}{' fused' if args.fused else ''}"
          f"{f' spec_k={args.spec_k}' if args.spec_k else ''}"
          f"{f' spec_tree={args.spec_tree}' if spec_trees else ''}"
          f"{f' temperature={args.temperature}' if args.temperature else ''}")
    engine.warmup()
    supervisor = None
    if failure_plan is not None or args.tick_timeout_s > 0:
        warmed = [engine]

        def factory():
            if warmed:  # the first call adopts the engine warmed above
                return warmed.pop()
            eng = build_engine()
            eng.warmup()
            return eng

        supervisor = ExecutorSupervisor(
            factory, failure_plan=failure_plan,
            tick_timeout_s=args.tick_timeout_s or None)
    for i in range(n_requests):
        engine.submit(Request(rid=i, prompt=(1 + i % (cfg.vocab_size - 1),),
                              max_new_tokens=per_req,
                              slo_class="interactive" if i % 3 == 0 else "batch",
                              deadline_s=args.deadline_s or None))
    scaler = None
    if args.autoscale and args.budget_ms <= 0:
        ap.error("--autoscale requires --budget-ms (the SLO loop hosts the "
                 "autoscale tick)")
    policy = None
    if args.budget_ms > 0:
        if args.autoscale:
            from repro_torch.runtime.autoscale import (AutoscaleConfig,
                                                       AutoscalePolicy,
                                                       Autoscaler)
            try:
                ks = tuple(int(k) for k in args.autoscale_ks.split(",")
                           if k.strip())
            except ValueError:
                ap.error(f"--autoscale-ks wants comma-separated draft "
                         f"lengths, got {args.autoscale_ks!r}")
            scaler = Autoscaler(AutoscaleConfig(
                interval_ticks=args.autoscale_interval,
                table_budget=args.autoscale_table_budget or None,
                spec_ks=ks, explore_modes=args.autoscale_explore_modes,
                pop_size=args.autoscale_pop,
                generations=args.autoscale_gens,
                seed=args.seed)).bind(engine)
            policy = AutoscalePolicy(cfg, engine.ctrl, autoscaler=scaler,
                                     batch_size=args.batch,
                                     cache_capacity=capacity,
                                     metrics=engine.metrics,
                                     executor=engine.executor)
        else:
            policy = SLOPolicy(cfg, engine.ctrl, batch_size=args.batch,
                               cache_capacity=capacity,
                               executor=engine.executor)
        if supervisor is not None:
            supervisor.attach_policy(policy)
    mode_idx = len(modes) - 1
    busy = 0.0
    while True:
        # a failover swaps the engine out from under the loop
        engine = supervisor.engine if supervisor is not None else engine
        if scaler is not None and scaler.engine is not engine:
            scaler.bind(engine)  # a failover swapped the engine: re-attach
        if not (engine.queue or engine.n_active):
            break
        if policy is not None:
            engine.set_admission_mode(policy.choose(args.budget_ms * 1e-3))
        elif engine.step_count and engine.step_count % args.switch_every == 0:
            mode_idx = (mode_idx - 1) % len(modes)  # degrade then wrap
            engine.set_admission_mode(modes[mode_idx])
        if supervisor is not None:
            busy += supervisor.tick(now_s=busy)
        else:
            busy += engine.step(now_s=busy)
    if supervisor is not None:
        if failure_plan is not None:
            missed = set(failure_plan.at_sites) - failure_plan.fired_sites
            if missed:
                print(f"[serve] warning: planned failures never reached "
                      f"(too few launches at those sites): {sorted(missed)}")
        for e in supervisor.failover_log:
            ftok = (f"{e['first_token_s'] * 1e3:.0f} ms"
                    if e["first_token_s"] is not None else "n/a")
            print(f"[serve] failover @step {e['step']}: {e['cause']} | "
                  f"rebuild {e['rebuild_s'] * 1e3:.0f} ms, "
                  f"replay {e['replay_s'] * 1e3:.0f} ms, "
                  f"first token {ftok}")
    ctrl = engine.ctrl
    if scaler is not None:
        scaler._drain_publish()  # land any adoption still in flight
        assert ctrl.stats["compiles"] == \
            engine.compiles_after_warmup + scaler.stats["published_keys"], \
            "every build after warmup must come through publish_aux"
        assert scaler.stats["tick_stalls"] == 0, \
            "a background build stalled a serving tick"
    else:
        assert ctrl.stats["compiles"] == engine.compiles_after_warmup, \
            "runtime switch must not rebuild a step"
    generated = sum(len(r.generated) for r in engine.completed)
    # one checksum of every completed stream, in request order: a failover
    # drill prints the fault-free run's value
    streams = sorted((r.rid, tuple(r.generated)) for r in engine.completed)
    digest = zlib.crc32(repr(streams).encode())
    print(f"[serve] completed={len(engine.completed)} "
          f"expired={len(engine.expired)} "
          f"failovers={supervisor.failovers if supervisor else 0} "
          f"generated={generated} streams_crc32={digest:08x} "
          f"switches={ctrl.stats['switches']} "
          f"admission_switches={len(engine.admission_switch_log)} "
          f"recompiles_after_warmup=0 dispatches={ctrl.stats['dispatches']} "
          f"executables={ctrl.stats['compiles']} (per depth, plus draft "
          f"and verify steps) "
          f"decode_launches={engine.decode_launches} "
          f"(per-mode baseline {engine.per_mode_launch_equiv}) "
          f"prefills={engine.prefills} "
          f"spec_verify_launches={engine.spec_verify_launches} "
          f"(tree {engine.spec_tree_launches}) "
          f"tokens/s={generated / busy if busy else 0.0:.1f}")
    for name, t in ctrl.telemetry_summary().items():
        mode = ctrl.mode_by_name[name]
        frac = elastic.flops_fraction(cfg, mode)
        print(f"  mode {name:8s} p50 {t['p50_ms']:8.2f} ms  p95 {t['p95_ms']:8.2f} ms  "
              f"{t['tokens_per_s']:8.1f} tok/s  active-FLOPs {frac * 100:5.1f}%")
    for path, t in engine.spec_telemetry_summary().items():
        nodes = (f"  tree {t['tree']} ({t['draft_nodes']} draft nodes)"
                 if "tree" in t else "")
        print(f"  spec {path:10s} accept {t['accept_rate'] * 100:5.1f}%  "
              f"accepted/launch {t['accepted_per_launch']:.2f}  "
              f"tokens/launch {t['tokens_per_launch']:.2f} "
              f"(per-slot {t['tokens_per_slot_launch']:.2f})  "
              f"launches {t['launches']}{nodes}")
    if engine.spec_fallback_log:
        print(f"  spec fallbacks: {list(engine.spec_fallback_log)}")
    if scaler is not None:
        st = scaler.stats
        print(f"[serve] autoscale generations={st['generations']} "
              f"published={st['published']} retired={st['retired']} "
              f"front={len(scaler.front)} "
              f"table={ctrl.compile_table_size} "
              f"tick_stalls={st['tick_stalls']} dropped={st['dropped']}")
        for pt, obj in zip(scaler.front, scaler.front_objectives):
            print(f"  front d{pt.depth} w{pt.width} spec_k={pt.spec_k} "
                  f"tree={pt.spec_tree} bucket={pt.bucket} "
                  f"lat/tok={obj[0] * 1e3:.2f} ms")
        scaler.close()
    if paged is not None:
        engine.check_paged_invariants()
        for depth, st in sorted(engine.page_pool_stats().items()):
            radix = (f"radix hit-rate {st['radix_hit_rate'] * 100:.0f}% "
                     f"({st['radix_nodes']} nodes)"
                     if "radix_hit_rate" in st else "fixed pages (window)")
            print(f"  pages depth={depth}: pool {st['n_pages']} "
                  f"peak {st['peak_in_use']} allocs {st['allocs']} {radix}")
    if args.trace_out:
        obs.recorder.write(args.trace_out)
        print(f"[serve] wrote {len(obs.recorder.events)} trace events to "
              f"{args.trace_out}")
    if args.metrics_dump:
        print("[serve] metrics (prometheus):")
        print(engine.metrics.prometheus_text(), end="")
        print("[serve] metrics (json):")
        print(json.dumps(engine.export_metrics(), indent=2, sort_keys=True))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
