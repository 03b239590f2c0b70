"""Online NeuroForge autoscaler: live MOGA over the executable pool.

Port of ``repro.runtime.autoscale``, with the reference's names and
semantics. What differs on the card is the background builder: it warms
each unit under ``torch.no_grad()`` (grad mode is per thread, and a hand
kernel refuses to launch under autograd) on a CUDA stream of its own, so
the serving thread's ``timed_step`` never waits for it; it synchronizes
that stream before handing a unit over, drops the warm run's draft
buffers (the serving thread allocates its own at first use), builds its
own width tensors instead of writing into the engine's memo, and counts
its kernel launches apart (``build_launches``), so the wrappers' counters
hold the serving thread's alone.

The offline compiler (``core.neuroforge``) searches deploy-time shardings
once; this module re-runs the same NSGA-II loop *while serving*, over a
runtime design space — (depth, width) admission modes, speculative draft
shapes, paged-KV table buckets — with an evaluator blended from live
telemetry: measured per-mode latency (``SLOPolicy.est_latency``), measured
draft acceptance (``ServingEngine.spec_telemetry`` / rolling accept
windows), and the queue class mix. The Pareto front it maintains drives
three actuations:

* **adopt** — frontier points whose steps are not yet built are built
  and warmed on a background daemon thread, then atomically
  installed via ``MorphController.publish_aux`` (two dict assignments on
  the serving thread: publish-then-swap, never a compile on a serving
  tick — ``stats['tick_stalls']`` asserts it);
* **retire** — when the compile table exceeds ``table_budget``, the
  coldest unassigned unit (a (depth, K) draft/verify pair, a tree pair, or
  a page-bucket column of decode executables) is evicted through
  ``MorphController.unregister_aux``; paged launches round up to the next
  surviving bucket (bit-identical), speculative groups fall back to the
  surviving shapes (rollback-exact, so committed tokens never change);
* **steer** — ``AutoscalePolicy`` restricts admission to the front's
  modes (or pins the mode entirely, the bit-identity configuration).

Snapshot/restore carries the autoscaler's state (front, generation,
published/retired units) so post-failover behaviour is deterministic: a
standby that absorbs a snapshot re-publishes the adopted units
synchronously (the recovery path may compile) and re-applies retirements
before serving resumes.

Over a mesh (an engine on a ``MeshExecutor``) every rank runs its own
autoscaler, and all of them build, publish and retire the same units on
the same tick, where the reference drives one SPMD program from one
process:

* decisions taken from a clock go through the executor's ``agree`` (rank
  0's value): a generation's front (its objectives read measured
  latencies, so only rank 0 runs the MOGA) and each retirement;
* the builder's warm runs issue their collectives on process groups of
  their own, made at ``bind`` over the mesh's ranks in the same order on
  every rank (``tensor_parallel.route``), so they never interleave with
  the serving thread's; under NCCL they run on the worker's stream;
* while a build is pending, each drain gathers every rank's finished
  units on the serving thread and publishes the units finished on all of
  them, in one order; a unit any rank failed to build is dropped on all.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import itertools
import queue
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from repro_torch import kernels
from repro_torch.parallel import tensor_parallel as TP
from repro_torch.configs.base import MorphMode
from repro_torch.core import elastic
from repro_torch.core.elastic import flops_fraction
from repro_torch.core.morph import (_block_until_ready,
                                    paged_decode_compile_key)
from repro_torch.core.neuroforge.analytical import estimate_mode
from repro_torch.core.neuroforge.moga import (Constraints, Individual,
                                              non_dominated, run_moga)
from repro_torch.runtime.observability import autoscale_events
from repro_torch.runtime.serving import SLOPolicy, _same
from repro_torch.runtime.speculative import (draft_compile_key,
                                             expected_tokens_per_launch,
                                             expected_tokens_per_tree_launch,
                                             per_candidate_accept_rate,
                                             tree_draft_compile_key,
                                             tree_verify_compile_key,
                                             verify_compile_key)

__all__ = ["ServePoint", "ServeSpace", "AutoscaleConfig", "Autoscaler",
           "AutoscalePolicy", "measured_accept_rate"]


@dataclass(frozen=True)
class ServePoint:
    """One point of the runtime design space the online MOGA searches.

    ``depth``/``width`` name an admission mode from the deployed table
    (modes share per-depth compile keys, so this axis never costs a
    compile); ``spec_k``/``spec_tree`` the draft shape (0/None = plain
    stepping); ``bucket`` the paged-KV table width (0 = dense serving).
    """

    depth: int
    width: float
    spec_k: int = 0
    spec_tree: Optional[Tuple[int, ...]] = None
    bucket: int = 0

    @property
    def mode(self) -> MorphMode:
        return MorphMode(depth=self.depth, width=self.width)


class ServeSpace:
    """Genome axes over a live engine's executable pool.

    Duck-types ``DesignSpace`` for ``run_moga`` (``bounds()``/``decode()``):
    axis 0 indexes the deployed (depth, width) mode table, axis 1 a draft
    shape (plain, each candidate linear K, each candidate tree), axis 2 the
    page-bucket ladder. ``decode`` normalizes invalid combinations — a
    depth with no speculative plan entry (nothing shallower to draft from)
    collapses to plain stepping — so every genome is executable.
    """

    def __init__(self, engine, spec_ks: Sequence[int] = (),
                 spec_trees: Sequence[Tuple[int, ...]] = ()):
        ctrl = engine.ctrl
        self.modes: List[Tuple[int, float]] = sorted(
            {(m.depth, m.width) for m in ctrl.modes})
        self.plan = ctrl.spec_plan  # live: adoption extends the entries
        ks: Set[int] = {int(k) for k in spec_ks}
        trees: Set[Tuple[int, ...]] = {tuple(br) for br in spec_trees}
        for e in self.plan.values():
            ks.update(e.ks)
            trees.update(e.trees)
        self.spec_choices: List[Tuple[str, object]] = (
            [("plain", None)] + [("k", k) for k in sorted(ks)] +
            [("tree", br) for br in sorted(trees)])
        if engine.paged is not None:
            self.buckets = sorted(
                engine.paged.buckets(engine.cfg, engine.cache_capacity))
        else:
            self.buckets = [0]

    def bounds(self) -> Tuple[int, ...]:
        return (len(self.modes), len(self.spec_choices), len(self.buckets))

    def decode(self, genes: Tuple[int, ...]) -> ServePoint:
        d, w = self.modes[genes[0] % len(self.modes)]
        kind, shape = self.spec_choices[genes[1] % len(self.spec_choices)]
        if self.plan.get(d) is None:
            kind, shape = "plain", None
        return ServePoint(
            depth=d, width=w,
            spec_k=int(shape) if kind == "k" else 0,
            spec_tree=tuple(shape) if kind == "tree" else None,
            bucket=self.buckets[genes[2] % len(self.buckets)])


def measured_accept_rate(engine, depth: int, default: float = 0.75) -> float:
    """Per-candidate draft acceptance for ``depth``: the rolling accept
    window first, lifetime telemetry second (launch-weighted, each path's
    depth fraction converted to the per-candidate rate), the optimistic
    default before any data — the same ladder ``_retune_spec`` climbs."""
    g = engine.groups.get(depth)
    if g is not None and g.accept_window:
        return float(np.mean(g.accept_window))
    tels = [t for (d, _dd, _k), t in engine.spec_telemetry.items()
            if d == depth and t.drafted and t.slot_launches]
    if tels:
        return (sum(per_candidate_accept_rate(t.accepted / t.drafted, t.tree)
                    * t.slot_launches for t in tels)
                / sum(t.slot_launches for t in tels))
    return default


@dataclass
class AutoscaleConfig:
    """Knobs for the online autoscaler.

    ``table_budget`` bounds ``MorphController.compile_table_size`` (None
    disables eviction); ``spec_ks``/``spec_trees`` are CANDIDATE draft
    shapes the MOGA may adopt beyond the hand-warmed plan;
    ``explore_modes`` lets ``AutoscalePolicy`` move admission across the
    front's modes (off = pinned mode, the bit-identity configuration);
    ``cold_dispatches`` is the dwell: a unit retires only after that many
    dispatches without a use.
    """

    interval_ticks: int = 8
    table_budget: Optional[int] = None
    spec_ks: Tuple[int, ...] = ()
    spec_trees: Tuple[Tuple[int, ...], ...] = ()
    explore_modes: bool = False
    pop_size: int = 16
    generations: int = 4
    seed: int = 0
    queue_gamma: float = 0.25
    cold_dispatches: int = 0


class Autoscaler:
    """Live MOGA over the executable pool of one serving engine.

    ``bind(engine)`` attaches (and re-attaches after failover — the
    engine's ``_pending_autoscale`` stash from a restored snapshot is
    applied); ``tick()`` runs on the serving thread every policy decision
    and never compiles: it drains the background builder's finished units,
    publishes them atomically, runs a MOGA generation every
    ``interval_ticks``, and retires cold units while the compile table
    exceeds the budget.
    """

    def __init__(self, config: Optional[AutoscaleConfig] = None):
        self.config = config or AutoscaleConfig()
        self.engine = None
        self.front: List[ServePoint] = []
        self.front_objectives: List[Tuple[float, ...]] = []
        self.generation = 0
        self.tick_count = 0
        self.stats = {"generations": 0, "published": 0, "published_keys": 0,
                      "retired": 0, "scheduled": 0, "tick_stalls": 0,
                      "dropped": 0}
        # thread idents the compile worker reported from — tests assert the
        # serving thread never appears here
        self.worker_idents: Set[int] = set()
        # kernel launches of the builds' warm runs (kernel name -> its
        # counters, as ``kernels.counted_apart`` keeps them)
        self.build_launches: Dict[str, Dict] = {}
        self._jobs: "queue.Queue" = queue.Queue()
        self._done: "queue.Queue" = queue.Queue()
        self._pending: Set[Tuple] = set()        # scheduled, not yet drained
        self._inflight_keys: Set[Tuple] = set()  # built, not yet published
        self._published_units: List[Tuple] = []
        self._retired_units: List[Tuple] = []
        self._expected_compiles: Optional[int] = None
        self._events = None
        self._worker: Optional[threading.Thread] = None
        # over a mesh: the ranks, rank 0's choice, every rank's finished
        # units (unit -> (built, ok)) until all ranks have them, and the
        # builder's process groups (made once per mesh)
        self._world = 1
        self._lead = True
        self._agree = _same
        self._finished: Dict[Tuple, Tuple] = {}
        self._builder_mesh = None
        self._builder_groups = (None, None)
        self._builder_comm = None

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    def bind(self, engine) -> "Autoscaler":
        """Attach to ``engine`` (idempotent; rebind after failover).

        Publishes the engine's stashed autoscale snapshot if a bare standby
        absorbed one before any autoscaler existed, registers the gauge
        callback + event stream, and starts the compile worker. Over a mesh
        every rank binds its own autoscaler at the same point: the first
        bind on a mesh makes the builder's process groups (a collective
        call).
        """
        self._bind_mesh(engine.executor)
        self.engine = engine
        engine.autoscaler = self
        self._events = autoscale_events(engine.metrics)
        engine.metrics.register_callback(self._gauges, key="autoscale")
        self._expected_compiles = None  # resync on first tick (post-warmup)
        if engine._pending_autoscale is not None:
            state, engine._pending_autoscale = engine._pending_autoscale, None
            self.load_state(state)
        if self._worker is None:
            self._worker = threading.Thread(target=self._worker_loop,
                                            name="autoscale-compile",
                                            daemon=True)
            self._worker.start()
        return self

    def _bind_mesh(self, ex) -> None:
        """Take the executor's ``agree`` and, over a mesh of more than one
        rank, a ``ShardComm`` for the builder on groups of its own."""
        import torch.distributed as dist

        self._agree = ex.agree
        self._world = dist.get_world_size() if ex.mesh is not None else 1
        self._lead = self._world == 1 or dist.get_rank() == 0
        if self._world == 1:
            self._builder_comm = None
            return
        if self._builder_mesh is not ex.mesh:
            ranks = ex.mesh.mesh
            me = dist.get_rank()
            mine = {}
            for name in ("model", "data"):
                if name not in ex.mesh.mesh_dim_names:
                    continue
                dim = ex.mesh.mesh_dim_names.index(name)
                rows = ranks.movedim(dim, -1).reshape(-1, ranks.shape[dim])
                for row in rows.tolist():  # every rank, in one order
                    g = dist.new_group(ranks=row)
                    if me in row:
                        mine[name] = g
            self._builder_mesh = ex.mesh
            self._builder_groups = (mine.get("model"), mine.get("data"))
        self._builder_comm = ex.comm.over(*self._builder_groups)

    def close(self) -> None:
        """Stop the compile worker (tests; daemon thread otherwise). Over a
        mesh it first finishes every queued build: the other ranks'
        builders wait for this one's collectives."""
        if self._worker is not None:
            self._jobs.put(None)
            self._worker.join(timeout=None if self._world > 1 else 5.0)
            self._worker = None

    # ------------------------------------------------------------------
    # serving-thread tick
    # ------------------------------------------------------------------

    def tick(self, policy: SLOPolicy, budget_s: float,
             queue_depths: Optional[Dict[str, int]] = None) -> None:
        """One autoscaler step on the serving thread — never compiles."""
        eng = self.engine
        if eng is None:
            raise RuntimeError("autoscaler is not bound to an engine")
        ctrl = eng.ctrl
        self._drain_publish()
        if self._expected_compiles is None:
            self._expected_compiles = ctrl.stats["compiles"]
        if ctrl.stats["compiles"] != self._expected_compiles:
            # something compiled on the serving path (a stall) — count it
            # and resync so one miss is not recounted forever
            self.stats["tick_stalls"] += 1
            self._expected_compiles = ctrl.stats["compiles"]
        self.tick_count += 1
        if self.tick_count % max(self.config.interval_ticks, 1) == 0:
            self._run_generation(policy, budget_s, queue_depths)
        self._retire_over_budget()

    def _run_generation(self, policy: SLOPolicy, budget_s: float,
                        queue_depths: Optional[Dict[str, int]]) -> None:
        """One generation: the front (rank 0's over a mesh), then the
        builds of the units it wants."""
        found = (self._search(policy, budget_s, queue_depths)
                 if self._lead else None)
        if self._world > 1:
            found = self._agree(found)
        front, objectives, evaluations = found
        self.generation += 1
        self.stats["generations"] += 1
        self.front = [ServePoint(*p) for p in front]
        self.front_objectives = [tuple(o) for o in objectives]
        self._events.emit(step=self.engine.step_count, event="generation",
                          unit="", generation=self.generation,
                          detail=f"front={len(self.front)} "
                                 f"evals={evaluations}")
        for unit in self._front_units():
            self._schedule(unit)

    def _search(self, policy: SLOPolicy, budget_s: float,
                queue_depths: Optional[Dict[str, int]]):
        """The MOGA over the live pool: (front points as tuples, their
        objectives, evaluations)."""
        eng = self.engine
        cfg = eng.cfg
        space = ServeSpace(eng, self.config.spec_ks, self.config.spec_trees)
        rates = {d: measured_accept_rate(eng, d) for d in eng.groups}
        mode_by_dw = {(m.depth, m.width): m for m in eng.ctrl.modes}
        cap_bucket = max(space.buckets)
        plan = eng.ctrl.spec_plan

        def ev(pt: ServePoint):
            return estimate_mode(cfg, policy._cell, policy.design_point,
                                 depth=pt.depth, width=pt.width,
                                 hw=policy._hw)

        def objs(pt: ServePoint, rep) -> Tuple[float, float, float]:
            mode = mode_by_dw[(pt.depth, pt.width)]
            lat = policy.est_latency(mode)
            e = plan.get(pt.depth)
            if e is not None and (pt.spec_k or pt.spec_tree is not None):
                # launch-bound regime: a whole draft chain is ONE launch, so
                # a speculative tick costs (1 + draft_depth/depth) launches
                # and emits E[tokens/launch] at the measured acceptance —
                # per-token latency divides by it (strictly better for any
                # larger K once acceptance is positive: adoption is
                # deterministic, not noise-driven)
                rate = rates.get(pt.depth, 0.75)
                per_launch = 1.0 + e.draft_depth / pt.depth
                if pt.spec_tree is not None:
                    eff = expected_tokens_per_tree_launch(rate, pt.spec_tree)
                else:
                    eff = expected_tokens_per_launch(rate, pt.spec_k)
                lat = lat * per_launch / max(eff, 1.0)
            frac = (pt.bucket / cap_bucket) if (cap_bucket and pt.bucket) \
                else 1.0
            resource = rep.hbm_capacity_per_chip * frac
            quality = 1.0 - flops_fraction(cfg, mode)
            return (lat, resource, quality)

        # queue class mix squeezes the latency constraint exactly like the
        # admission budget: under backlog only fast points stay feasible
        pressure = policy._queue_pressure(queue_depths)
        cons = Constraints(
            hbm_bytes=policy._hw.hbm_bytes,
            latency_s=(budget_s / (1.0 + self.config.queue_gamma * pressure)
                       if budget_s and budget_s > 0 else None))
        res = run_moga(cfg, policy._cell, constraints=cons,
                       pop_size=self.config.pop_size,
                       generations=self.config.generations,
                       seed=self.config.seed + self.generation,
                       hw=policy._hw, evaluate=ev, space=space,
                       objectives=objs)
        front = res.pareto
        bounds = space.bounds()
        n_space = 1
        for b in bounds:
            n_space *= b
        if n_space <= max(self.config.pop_size
                          * (self.config.generations + 1), 256):
            # the runtime pool is smaller than the MOGA's own evaluation
            # budget: sweep the genomes the sampled population missed and
            # refine the front exactly — a dominated point must never
            # protect an executable from eviction just because its
            # dominator missed the final population
            pool = list(res.population)
            seen = {ind.genes for ind in pool}
            for genes in itertools.product(*(range(b) for b in bounds)):
                if genes in seen:
                    continue
                pt = space.decode(genes)
                rep = ev(pt)
                viol = max(0.0, (rep.hbm_capacity_per_chip - cons.hbm_bytes)
                           / cons.hbm_bytes)
                if cons.latency_s is not None:
                    viol += max(0.0, (rep.latency_s - cons.latency_s)
                                / cons.latency_s)
                pool.append(Individual(genes=genes, point=pt, report=rep,
                                       objectives=tuple(objs(pt, rep)),
                                       violation=viol))
            front = non_dominated(pool)
        # several genomes decode to one normalized point — dedupe the front
        # by point so gauges and adoption see distinct design points
        uniq: List[Individual] = []
        seen_pts: Set[ServePoint] = set()
        for ind in front:
            if ind.point not in seen_pts:
                seen_pts.add(ind.point)
                uniq.append(ind)
        return ([dataclasses.astuple(ind.point) for ind in uniq],
                [tuple(float(x) for x in ind.objectives) for ind in uniq],
                res.evaluations)

    # ------------------------------------------------------------------
    # adoption: background build, serving-thread publish
    # ------------------------------------------------------------------

    def _front_units(self) -> List[Tuple]:
        """Units the current front wants that are not yet live."""
        eng = self.engine
        plan = eng.ctrl.spec_plan
        units: List[Tuple] = []
        for pt in self.front:
            e = plan.get(pt.depth)
            if e is not None:
                if pt.spec_k and pt.spec_k not in e.ks:
                    units.append(("spec_k", pt.depth, pt.spec_k))
                if pt.spec_tree is not None and pt.spec_tree not in e.trees:
                    units.append(("spec_tree", pt.depth, pt.spec_tree))
            if pt.bucket and pt.bucket not in eng._avail_buckets:
                units.append(("bucket", pt.bucket))
        seen: Set[Tuple] = set()
        out = []
        for u in units:
            if u not in seen:
                seen.add(u)
                out.append(u)
        return out

    def _schedule(self, unit: Tuple) -> None:
        if unit in self._pending:
            return
        self._pending.add(unit)
        self.stats["scheduled"] += 1
        self._jobs.put((unit, self.engine))

    def _worker_loop(self) -> None:
        stream = None  # the worker's own CUDA stream, made at its first job
        while True:
            job = self._jobs.get()
            if job is None:
                return
            unit, eng = job
            try:
                if stream is None and eng.device.type == "cuda":
                    stream = torch.cuda.Stream(device=eng.device)
                with TP.route(self._builder_comm):
                    built = self._build_unit(unit, eng, stream)
                err = None
            except Exception as exc:  # surfaced through stats, not a crash
                built, err = None, repr(exc)
            self._done.put((unit, built, id(eng), threading.get_ident(), err))

    def _build_unit(self, unit: Tuple, eng,
                    stream: Optional["torch.cuda.Stream"] = None
                    ) -> List[Tuple]:
        """Build + warm every missing step of ``unit`` (off-thread), under
        ``torch.no_grad()``, on ``stream`` when given (else the current
        stream), its launches counted into ``build_launches``; the stream
        is synchronized before this returns. Returns ``[(key, fn,
        factory), ...]`` for the publish step."""
        on_stream = (torch.cuda.stream(stream) if stream is not None
                     else contextlib.nullcontext())
        with torch.no_grad(), on_stream, \
                kernels.counted_apart(self.build_launches):
            return self._warm_unit(unit, eng)

    def _warm_unit(self, unit: Tuple, eng) -> List[Tuple]:
        """``_build_unit``'s body: warms against throwaway caches with zero
        operands as ``ServingEngine.warmup`` does, each chain on a fresh
        ``init_cache()``, with width tensors of its own (the engine's memo
        holds the serving stream's)."""
        ctrl = eng.ctrl
        ex = eng.executor
        bsz = eng.batch_size
        tok = ex.put(np.zeros((bsz, 1), np.int64))
        active = elastic.active_widths_batch(eng.cfg, [1.0] * bsz,
                                             device=eng.device)

        def want(key) -> bool:
            if key in self._inflight_keys:
                return False
            return key not in ctrl.aux_keys() and \
                key not in ctrl.compiled_keys()

        built: List[Tuple] = []
        if unit[0] == "bucket":
            b = unit[1]
            for d in sorted(eng.groups):
                key = paged_decode_compile_key(d, b)
                if not want(key):
                    continue
                factory = ctrl.aux_builders["paged_decode"](d, b)
                fn = factory()
                pages_b = ex.put(np.zeros((bsz, b),
                                          eng.groups[d].paging.table.dtype))
                out = fn(eng.params, ex.init_cache(), tok, active, pages_b)
                _block_until_ready(out)
                built.append((key, fn, factory))
                self._inflight_keys.add(key)
            return built

        kind, depth, shape = unit
        e = ctrl.spec_plan[depth]
        dd = e.draft_depth
        g = eng.groups[depth]
        spec_extra = ()
        if eng.paged is not None:
            spec_extra = (ex.put(
                np.zeros((bsz, g.paging.cap_pages), g.paging.table.dtype)),)
        if kind == "spec_k":
            dkey = draft_compile_key(dd, shape)
            vkey = verify_compile_key(depth, shape)
            dfac = ctrl.aux_builders["draft"](dd, shape)
            vfac = ctrl.aux_builders["verify"](depth, shape)
        else:
            dkey = tree_draft_compile_key(dd, shape)
            vkey = tree_verify_compile_key(depth, shape)
            dfac = ctrl.aux_builders["tree_draft"](dd, shape)
            vfac = ctrl.aux_builders["tree_verify"](depth, shape)
        dfn, vfn = dfac(), vfac()
        cache = ex.init_cache()
        dtoks, dlg = dfn(eng.params, cache, tok, active, g.keys,
                         eng.temperature, 0, *spec_extra)
        full = torch.cat([tok, dtoks], dim=1) if kind == "spec_k" \
            else dtoks
        out = vfn(eng.params, cache, full, dlg, active, g.keys,
                  eng.temperature, 0, *spec_extra)
        _block_until_ready(out)
        # the draft's scratch (its carry, for a tree) came from this
        # stream's pool: the serving thread allocates its own at first use
        dfn.release()
        if want(dkey):  # draft keys are shared across depths with one dd
            built.append((dkey, dfn, dfac))
            self._inflight_keys.add(dkey)
        if want(vkey):
            built.append((vkey, vfn, vfac))
            self._inflight_keys.add(vkey)
        return built

    def _drain_publish(self) -> None:
        """Install every finished unit (serving thread; dict swaps only).
        Over a mesh, while a build is pending, a collective: only the
        units every rank has finished are installed, on every rank in one
        order."""
        while True:
            try:
                unit, built, eng_id, ident, err = self._done.get_nowait()
            except queue.Empty:
                break
            self.worker_idents.add(ident)
            # a stale engine after a failover, or a failed build: dropped,
            # the next generation reschedules against the live engine
            ok = eng_id == id(self.engine) and err is None \
                and built is not None
            if self._world == 1:
                self._install(unit, built, ok)
            else:
                self._finished[unit] = (built, ok)
        if self._world == 1 or not self._pending:
            return
        import torch.distributed as dist

        got = [None] * self._world
        dist.all_gather_object(got, sorted(
            (repr(u), ok) for u, (_b, ok) in self._finished.items()))
        every = [dict(g) for g in got]
        for unit in sorted(self._finished, key=repr):
            oks = [e.get(repr(unit)) for e in every]
            if None in oks:
                continue  # another rank is still building it
            built, _ok = self._finished.pop(unit)
            self._install(unit, built, all(oks))

    def _install(self, unit: Tuple, built, ok: bool) -> None:
        self._pending.discard(unit)
        if built is not None:
            for key, _fn, _fac in built:
                self._inflight_keys.discard(key)
        if not ok:
            self.stats["dropped"] += 1
            return
        self._activate(unit, built)

    def await_builds(self, timeout_s: float = 300.0,
                     poll_s: float = 0.01) -> bool:
        """Drain until no build is pending or ``timeout_s`` has passed (on
        rank 0's clock over a mesh); True if none is left pending."""
        t0 = time.monotonic()
        while self._pending:
            self._drain_publish()
            late = time.monotonic() - t0 > timeout_s
            if self._world > 1:
                late = self._agree(late)
            if not self._pending or late:
                break
            time.sleep(poll_s)
        return not self._pending

    def _unit_active(self, unit: Tuple) -> bool:
        eng = self.engine
        if unit[0] == "bucket":
            return unit[1] in eng._avail_buckets
        kind, d, shape = unit
        e = eng.ctrl.spec_plan.get(d)
        if e is None:
            return False
        return shape in (e.ks if kind == "spec_k" else e.trees)

    def _activate(self, unit: Tuple, built: List[Tuple], *,
                  record: bool = True) -> int:
        """Publish ``built`` and wire ``unit`` into the live tables."""
        eng = self.engine
        ctrl = eng.ctrl
        if self._unit_active(unit):
            return 0
        n = 0
        for key, fn, fac in built:
            if key in ctrl.aux_keys() or key in ctrl.compiled_keys():
                continue
            ctrl.publish_aux(key, fn, factory=fac)
            if self._expected_compiles is not None:
                self._expected_compiles += 1
            n += 1
        if unit[0] == "bucket":
            eng._avail_buckets.add(unit[1])
        else:
            kind, d, shape = unit
            e = ctrl.spec_plan[d]
            if kind == "spec_k":
                ctrl.spec_plan[d] = dataclasses.replace(
                    e, ks=tuple(sorted(set(e.ks) | {shape})))
            else:
                ctrl.spec_plan[d] = dataclasses.replace(
                    e, trees=tuple(sorted(set(e.trees) | {shape})))
        if unit not in self._published_units:
            self._published_units.append(unit)
        if unit in self._retired_units:
            self._retired_units.remove(unit)
        if record:
            self.stats["published"] += 1
            self.stats["published_keys"] += n
            self._events.emit(step=eng.step_count, event="publish",
                              unit=_unit_label(unit),
                              generation=self.generation,
                              detail=f"keys={n} "
                                     f"table={ctrl.compile_table_size}")
        return n

    # ------------------------------------------------------------------
    # retirement
    # ------------------------------------------------------------------

    def _retirable_units(self) -> List[Tuple]:
        """Active units eligible for eviction.

        Protected: shapes a group currently runs, units the front still
        wants, units with a build in flight, and the cap bucket (paged
        launches must always find a covering bucket to round up to).
        """
        eng = self.engine
        protected: Set[Tuple] = set(self._pending)
        for pt in self.front:
            if pt.spec_k:
                protected.add(("spec_k", pt.depth, pt.spec_k))
            if pt.spec_tree is not None:
                protected.add(("spec_tree", pt.depth, pt.spec_tree))
            if pt.bucket:
                protected.add(("bucket", pt.bucket))
        out: List[Tuple] = []
        for d, e in eng.ctrl.spec_plan.items():
            g = eng.groups.get(d)
            for k in e.ks:
                u = ("spec_k", d, k)
                if u in protected or (g is not None and g.spec_k == k):
                    continue
                out.append(u)
            for br in e.trees:
                u = ("spec_tree", d, br)
                if u in protected or (g is not None and g.spec_tree == br):
                    continue
                out.append(u)
        if eng.paged is not None and eng.groups:
            cap = next(iter(eng.groups.values())).paging.cap_pages
            for b in sorted(eng._avail_buckets):
                u = ("bucket", b)
                if b == cap or u in protected:
                    continue
                out.append(u)
        return out

    def _unit_coldness(self, unit: Tuple) -> int:
        """Dispatches since the unit was last used (min over its keys —
        a unit is hot if ANY of its executables is; draft keys shared with
        another depth's plan are excluded, their heat is not this unit's)."""
        eng = self.engine
        ctrl = eng.ctrl
        if unit[0] == "bucket":
            keys = [paged_decode_compile_key(d, unit[1])
                    for d in sorted(eng.groups)]
        else:
            kind, d, shape = unit
            keys = [verify_compile_key(d, shape) if kind == "spec_k"
                    else tree_verify_compile_key(d, shape)]
        live = [k for k in keys if k in ctrl.aux_keys()]
        return min((ctrl.coldness(k) for k in live), default=0)

    def _retire_over_budget(self) -> None:
        budget = self.config.table_budget
        if budget is None or self.engine is None:
            return
        ctrl = self.engine.ctrl
        guard = 0
        while ctrl.compile_table_size > budget and guard < 64:
            guard += 1
            unit = self._retire_choice() if self._lead else None
            if self._world > 1:
                unit = self._agree(unit)
            if unit is None:
                return
            self._retire(unit)

    def _retire_choice(self) -> Optional[Tuple]:
        """The coldest retirable unit, or None when there is none or every
        one is still within its dwell."""
        cands = self._retirable_units()
        if not cands:
            return None
        unit = max(cands, key=lambda u: (self._unit_coldness(u), repr(u)))
        if self._unit_coldness(unit) <= self.config.cold_dispatches:
            return None
        return unit

    def _retire(self, unit: Tuple, *, record: bool = True) -> None:
        """Evict ``unit``: detach it from the live tables FIRST (so the
        next tick can never select a key that is gone), then unregister."""
        eng = self.engine
        ctrl = eng.ctrl
        removed: List[Tuple] = []
        if unit[0] == "bucket":
            b = unit[1]
            eng._avail_buckets.discard(b)  # launches round up from now on
            for d in sorted(eng.groups):
                key = paged_decode_compile_key(d, b)
                if key in ctrl.aux_keys():
                    ctrl.unregister_aux(key)
                    removed.append(key)
        else:
            kind, d, shape = unit
            e = ctrl.spec_plan[d]
            g = eng.groups.get(d)
            if kind == "spec_k":
                ctrl.spec_plan[d] = dataclasses.replace(
                    e, ks=tuple(k for k in e.ks if k != shape))
                if g is not None and g.spec_k == shape:
                    g.spec_k = max(ctrl.spec_plan[d].ks, default=0)
                vkey = verify_compile_key(d, shape)
                dkey = draft_compile_key(e.draft_depth, shape)
                shared = any(e2.draft_depth == e.draft_depth
                             and shape in e2.ks
                             for d2, e2 in ctrl.spec_plan.items() if d2 != d)
            else:
                ctrl.spec_plan[d] = dataclasses.replace(
                    e, trees=tuple(t for t in e.trees if t != shape))
                if g is not None and g.spec_tree == shape:
                    g.spec_tree = None
                vkey = tree_verify_compile_key(d, shape)
                dkey = tree_draft_compile_key(e.draft_depth, shape)
                shared = any(e2.draft_depth == e.draft_depth
                             and shape in e2.trees
                             for d2, e2 in ctrl.spec_plan.items() if d2 != d)
            if vkey in ctrl.aux_keys():
                ctrl.unregister_aux(vkey)
                removed.append(vkey)
            if not shared and dkey in ctrl.aux_keys():
                ctrl.unregister_aux(dkey)
                removed.append(dkey)
        if unit in self._published_units:
            self._published_units.remove(unit)
        if unit not in self._retired_units:
            self._retired_units.append(unit)
        if record:
            self.stats["retired"] += 1
            self._events.emit(step=eng.step_count, event="retire",
                              unit=_unit_label(unit),
                              generation=self.generation,
                              detail=f"keys={len(removed)} "
                                     f"table={ctrl.compile_table_size}")

    # ------------------------------------------------------------------
    # observability + snapshot/restore
    # ------------------------------------------------------------------

    def _gauges(self) -> Dict[str, float]:
        table = (self.engine.ctrl.compile_table_size
                 if self.engine is not None else 0)
        return {"autoscale_generation": float(self.generation),
                "autoscale_front_size": float(len(self.front)),
                "autoscale_compile_table": float(table),
                "autoscale_pending_compiles": float(len(self._pending)),
                "autoscale_published": float(self.stats["published"]),
                "autoscale_retired": float(self.stats["retired"])}

    def state_dict(self) -> Dict:
        """Serializable autoscaler state for ``EngineSnapshot.autoscale``."""
        eng = self.engine
        plan = eng.ctrl.spec_plan if eng is not None else {}
        return copy.deepcopy({
            "generation": self.generation,
            "tick_count": self.tick_count,
            "stats": dict(self.stats),
            "front": [[p.depth, p.width, p.spec_k,
                       list(p.spec_tree) if p.spec_tree is not None else None,
                       p.bucket] for p in self.front],
            "front_objectives": [list(o) for o in self.front_objectives],
            "published": [_unit_to_state(u) for u in self._published_units],
            "retired": [_unit_to_state(u) for u in self._retired_units],
            "active_spec": {d: {"ks": list(e.ks),
                                "trees": [list(br) for br in e.trees]}
                            for d, e in plan.items()},
            "avail_buckets": sorted(eng._avail_buckets)
            if eng is not None else [],
        })

    def load_state(self, state: Dict) -> None:
        """Restore autoscaler state onto the bound engine (deterministic
        post-failover behaviour).

        Reconciles the live tables exactly to the snapshot: units the
        snapshot had adopted but this controller lacks are re-built and
        re-published SYNCHRONOUSLY (the recovery path may compile — the
        no-stall guarantee covers serving ticks, and the baseline resyncs
        below), and anything live that the snapshot did not have is
        retired. MOGA seeding resumes from the restored generation, so a
        replayed trace takes identical adopt/retire decisions.
        """
        if self.engine is None:
            raise RuntimeError("bind() an engine before load_state()")
        eng = self.engine
        ctrl = eng.ctrl
        st = copy.deepcopy(state)
        self.generation = st["generation"]
        self.tick_count = st["tick_count"]
        self.stats.update(st["stats"])
        self.front = [
            ServePoint(depth=d, width=w, spec_k=k,
                       spec_tree=tuple(t) if t is not None else None,
                       bucket=b)
            for d, w, k, t, b in st["front"]]
        self.front_objectives = [tuple(o) for o in st["front_objectives"]]
        published = [_unit_from_state(u) for u in st["published"]]
        retired = [_unit_from_state(u) for u in st["retired"]]
        self._published_units = []
        self._retired_units = []
        # retire anything live that the snapshot did not carry (in-place
        # restores may hold executables published after the snapshot)
        want = st["active_spec"]
        for d in sorted(ctrl.spec_plan):
            e = ctrl.spec_plan[d]
            w = want.get(d) or want.get(str(d)) or {"ks": [], "trees": []}
            for k in list(e.ks):
                if k not in w["ks"]:
                    self._retire(("spec_k", d, k), record=False)
            for br in list(e.trees):
                if list(br) not in w["trees"]:
                    self._retire(("spec_tree", d, br), record=False)
        if eng.paged is not None:
            keep = set(st["avail_buckets"])
            for b in sorted(set(eng._avail_buckets) - keep):
                self._retire(("bucket", b), record=False)
        # re-publish adopted units this controller lacks (fresh standby)
        republished = 0
        for unit in published:
            if self._unit_active(unit):
                if unit not in self._published_units:
                    self._published_units.append(unit)
            else:
                built = self._build_unit(unit, eng)
                republished += self._activate(unit, built, record=False)
        self._retired_units = [u for u in retired
                               if u not in self._published_units]
        if republished:
            # a fresh controller: "published keys" now means keys published
            # into THIS compile table (keeps compiles == warmup + published)
            self.stats["published_keys"] = republished
        self._expected_compiles = ctrl.stats["compiles"]


def _unit_label(unit: Tuple) -> str:
    if unit[0] == "bucket":
        return f"bucket:{unit[1]}"
    kind, d, shape = unit
    return f"{kind}:d{d}:{shape}"


def _unit_to_state(unit: Tuple) -> List:
    if unit[0] == "bucket":
        return ["bucket", int(unit[1])]
    kind, d, shape = unit
    return [kind, int(d),
            list(shape) if isinstance(shape, tuple) else int(shape)]


def _unit_from_state(u: List) -> Tuple:
    if u[0] == "bucket":
        return ("bucket", int(u[1]))
    shape = tuple(u[2]) if isinstance(u[2], (list, tuple)) else int(u[2])
    return (u[0], int(u[1]), shape)


class AutoscalePolicy(SLOPolicy):
    """SLO policy that ticks an :class:`Autoscaler` on every decision and
    consults its live Pareto front.

    With ``explore_modes`` off (the default) admission stays pinned to one
    mode: frontier adoption then only changes draft shapes and page
    buckets — both token-identical under greedy decoding (rollback-exact
    verify; bucket round-up) — so committed streams are bit-identical to a
    fixed-mode run of the same trace. With it on, admission moves across
    the front's modes: the widest frontier mode whose measured latency
    fits the effective budget (the autoscaled analogue of
    ``policy_for_budget``).
    """

    def __init__(self, cfg, controller, *, autoscaler: Autoscaler,
                 explore_modes: Optional[bool] = None,
                 pinned_mode: Optional[MorphMode] = None, **kw):
        super().__init__(cfg, controller, **kw)
        self.autoscaler = autoscaler
        self.explore_modes = (autoscaler.config.explore_modes
                              if explore_modes is None else explore_modes)
        self.pinned_mode = pinned_mode or controller.modes[-1]

    def choose(self, budget_s: float,
               queue_depths: Optional[Dict[str, int]] = None) -> MorphMode:
        if self.autoscaler.engine is not None:
            self.autoscaler.tick(self, budget_s, queue_depths)
        mode = super().choose(budget_s, queue_depths)
        if not self.explore_modes:
            if mode.name != self.pinned_mode.name:
                mode = self.pinned_mode
                self.last_decision = dict(self.last_decision, mode=mode.name)
            return mode
        front_dw = {(p.depth, p.width) for p in self.autoscaler.front}
        cands = [m for m in self.controller.modes
                 if (m.depth, m.width) in front_dw]
        if not cands:
            return mode
        eff = self.last_decision.get("effective_budget_s", budget_s)
        ranked = sorted(cands, key=lambda m: flops_fraction(self.cfg, m))
        pick = ranked[0]
        for m in ranked:
            if self.est_latency(m) <= eff:
                pick = m
        pick = self._agree(pick)  # measured latencies: rank 0's
        if pick.name != mode.name:
            self.last_decision = dict(self.last_decision, mode=pick.name)
        return pick
