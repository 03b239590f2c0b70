"""Fault tolerance: checkpoint/restart training, failure injection,
straggler monitoring, and serving-engine failover.

Port of ``repro.runtime.fault_tolerance``. The failure model: a process
dies mid-step, the job restarts, and work resumes from the last durable
state in the same order. This module implements that contract for both
runtimes and lets tests *inject* the failures:

* ``TrainRunner.run``: a step loop with periodic checkpoints. Any
  ``SimulatedFailure`` is survived by calling ``run`` again: it restores
  the latest checkpoint and replays the step-keyed data stream
  (``data.pipeline.make_batch``), so ``run_with_restarts`` ends on the
  uninterrupted run's state bit for bit.
* ``ExecutorSupervisor``: the serving side. It wraps a ``ServingEngine``
  factory, snapshots host truth before every tick, and turns a launch
  failure (injected through ``FailurePlan.at_sites`` at the executor's
  ``launch_hook``, or a tick slower than ``tick_timeout_s``) into a
  failover: a fresh engine ``restore``s the pre-tick snapshot (its caches
  re-made by token replay) and redoes the tick.
* ``StragglerMonitor``: per-step wall times; a step slower than
  ``threshold`` x the window's median is flagged, with a pluggable hook.

Only ``SimulatedFailure`` (and the tick timeout) is recovered: a real CUDA
fault poisons the process's context, so the supervisor catches no error
from torch and such a fault ends the run. ``elastic_reshard`` moves a
sharded state from one mesh layout to another.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
import time
from typing import Any, Callable, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.morph import _block_until_ready
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.runtime.observability import Observability


class SimulatedFailure(RuntimeError):
    """Injected node failure (tests / chaos drills)."""


@dataclass
class StragglerMonitor:
    threshold: float = 2.0
    window: int = 50
    times: List[float] = field(default_factory=list)
    flagged: List[int] = field(default_factory=list)
    mitigations: int = 0
    on_straggler: Optional[Callable[[int, float, float], None]] = None

    def observe(self, step: int, seconds: float) -> bool:
        self.times.append(seconds)
        hist = self.times[-self.window:]
        med = float(np.median(hist))
        is_straggler = len(hist) >= 5 and seconds > self.threshold * med
        if is_straggler:
            self.flagged.append(step)
            self.mitigations += 1
            if self.on_straggler:
                self.on_straggler(step, seconds, med)
        return is_straggler


@dataclass
class FailurePlan:
    """Deterministic failure injection, by training step or by launch site.

    ``at_steps`` is the training form: fail when ``step in at_steps`` (once
    each). ``at_sites`` is the serving form: ``(site, occurrence)`` pairs,
    occurrence 1-based: ``("verify", 3)`` kills the third verify launch the
    plan ever sees. Occurrence counts are GLOBAL across failovers: a redone
    tick's launches count again, so a plan is one fixed schedule over the
    whole chaos run, not per-engine state.
    """
    at_steps: tuple = ()
    at_sites: Tuple[Tuple[str, int], ...] = ()
    _fired: set = field(default_factory=set)
    site_counts: Dict[str, int] = field(default_factory=dict)
    _site_fired: set = field(default_factory=set)

    def maybe_fail(self, step: int):
        if step in self.at_steps and step not in self._fired:
            self._fired.add(step)
            raise SimulatedFailure(f"injected node failure at step {step}")

    def maybe_fail_site(self, site: str):
        """Count one launch at ``site``; raise if a planned pair matches."""
        n = self.site_counts.get(site, 0) + 1
        self.site_counts[site] = n
        if (site, n) in self.at_sites and (site, n) not in self._site_fired:
            self._site_fired.add((site, n))
            raise SimulatedFailure(
                f"injected executor failure at {site} launch #{n}")

    @property
    def fired_sites(self) -> set:
        return set(self._site_fired)


class TrainRunner:
    """Restartable training loop around a ``step_fn``.

    ``step_fn(state, batch) -> (state, metrics)``, where ``state`` is any
    tree holding the trainables and the optimizer state (the port's steps
    update it in place). The runner owns checkpointing and the data order:
    the same runner (or a fresh one on the same directory) can ``run``
    again after a crash and continues where the last checkpoint left off.
    """

    def __init__(self, cfg, step_fn, init_state_fn, data_cfg: DataConfig,
                 ckpt_dir: str, ckpt_every: int = 10, keep: int = 3,
                 async_ckpt: bool = False,
                 failure_plan: Optional[FailurePlan] = None,
                 straggler: Optional[StragglerMonitor] = None):
        self.cfg = cfg
        self.step_fn = step_fn
        self.init_state_fn = init_state_fn
        self.data_cfg = data_cfg
        self.mgr = CheckpointManager(ckpt_dir, keep=keep,
                                     async_save=async_ckpt)
        self.ckpt_every = ckpt_every
        self.failure_plan = failure_plan or FailurePlan()
        self.straggler = straggler or StragglerMonitor()
        self.metrics_log: List[Dict[str, float]] = []

    def _restore_or_init(self):
        template = self.init_state_fn()
        if self.mgr.latest_step() is None:
            return template, 0
        state, meta = self.mgr.restore(template)
        return state, int(meta["step"])

    def run(self, total_steps: int) -> Any:
        state, start = self._restore_or_init()
        for step in range(start, total_steps):
            batch = make_batch(self.cfg, self.data_cfg, step)
            t0 = time.perf_counter()
            self.failure_plan.maybe_fail(step)
            state, metrics = self.step_fn(state, batch)
            _block_until_ready(state)
            dt = time.perf_counter() - t0
            self.straggler.observe(step, dt)
            self.metrics_log.append(
                {"step": step, "sec": dt,
                 **{k: float(v) for k, v in metrics.items()}})
            if (step + 1) % self.ckpt_every == 0 or step + 1 == total_steps:
                self.mgr.save(step + 1, state, {"data_step": step + 1})
        self.mgr.wait()
        return state

    def run_with_restarts(self, total_steps: int,
                          max_restarts: int = 10) -> Any:
        """Survive injected failures by restoring and replaying."""
        for attempt in range(max_restarts + 1):
            try:
                return self.run(total_steps)
            except SimulatedFailure:
                if attempt == max_restarts:
                    raise
                continue
        raise RuntimeError("unreachable")


def elastic_reshard(state, src, dst):
    """Re-place a sharded state pytree onto another mesh layout (a mesh
    change). ``src`` and ``dst`` are ``(mesh, specs)`` pairs over the same
    ranks, ``specs`` a spec tree matching ``state`` (``sharding.Spec``
    tuples): every leaf is all-gathered over the source mesh, then cut to
    this rank's slice under the destination layout."""
    from repro_torch.parallel import sharding as SH
    from repro_torch.parallel.tensor_parallel import gather_tree

    (src_mesh, src_specs), (dst_mesh, dst_specs) = src, dst
    return SH.shard_params(gather_tree(state, src_specs, src_mesh),
                           dst_specs, dst_mesh)


class ExecutorSupervisor:
    """Failover seam around a ``ServingEngine``: snapshot every tick,
    rebuild on a launch failure, resume with exact replay.

    ``engine_factory`` builds a geometry-compatible engine (the same modes,
    batch size, paged layout and sample seed: the ``restore`` contract). It
    is called once up front and once per failover; a factory that
    alternates two pre-warmed standbys makes a failover cost only the
    replay (restore resets an engine fully, so two can ping-pong forever).

    Failures surface two ways: an exception in ``recover_on`` raised out of
    the tick (``SimulatedFailure``; a real CUDA fault is not recoverable in
    the process and is not caught), or a tick whose wall time exceeded
    ``tick_timeout_s`` (the hung-executor path; its results are DISCARDED
    and the tick is redone on the standby). Either way: tear down, rebuild
    from the pre-tick snapshot, redo the tick. Uncommitted speculative work
    needs no bookkeeping: the snapshot predates the draft.

    ``failure_plan.maybe_fail_site`` (then ``launch_hook``) is armed as the
    engine executor's ``launch_hook``, firing at every announced launch:
    ``decode``, ``paged_decode``, ``verify``, ``tree_verify``,
    ``prefill``. Replay launches are not announced, so a planned failure
    cannot fire again mid-recovery; occurrence counts keep advancing across
    failovers (one global schedule).

    Failovers land on the observability layer: a ``supervisor_failover``
    event stream (``failover_log`` is a view of it) and a
    ``failover_recovery_ms`` histogram the SLO policy reads to downshift
    during catch-up (``SLOPolicy.note_failover``). ``observability``
    defaults to the first engine's; its clock times detection, rebuild and
    replay, so chaos tests stay deterministic under an injected clock. Both
    keep every failover when the engines keep registries of their own: a
    restore loads another engine's registry state, which the reference lets
    overwrite them with an older copy.
    """

    def __init__(self, engine_factory: Callable[[], Any], *,
                 failure_plan: Optional[FailurePlan] = None,
                 tick_timeout_s: Optional[float] = None,
                 max_failovers: int = 8,
                 recover_on: Tuple[type, ...] = (SimulatedFailure,),
                 launch_hook: Optional[Callable[[str], None]] = None,
                 observability: Optional[Observability] = None):
        self.factory = engine_factory
        self.plan = failure_plan
        self.tick_timeout_s = tick_timeout_s
        self.max_failovers = max_failovers
        self.recover_on = tuple(recover_on)
        self.launch_hook = launch_hook
        self.failovers = 0
        self._policy = None
        self._pending_first_token: Optional[Tuple[Dict[str, Any], float]] = None
        self.engine = engine_factory()
        self.obs = observability or getattr(self.engine, "obs", None) \
            or Observability()
        self._clock = self.obs.clock
        self.failover_events = self.obs.registry.events(
            "supervisor_failover",
            ("step", "cause", "detect_s", "rebuild_s", "replay_s",
             "first_token_s"))
        self.recovery_ms = self.obs.registry.histogram("failover_recovery_ms")
        self._arm()

    @property
    def failover_log(self):
        """Structured failover entries (a view of ``failover_events``)."""
        return self.failover_events

    def _arm(self) -> None:
        self.engine.executor.launch_hook = self._on_launch

    def _on_launch(self, site: str) -> None:
        if self.plan is not None:
            self.plan.maybe_fail_site(site)
        if self.launch_hook is not None:
            self.launch_hook(site)

    def attach_policy(self, policy) -> None:
        """Register the SLO policy, so a failover rebinds it to the new
        engine's controller (its telemetry source) and starts its
        catch-up."""
        self._policy = policy

    def _failover(self, snap, cause: str, detect_s: float) -> None:
        self.failovers += 1
        if self.failovers > self.max_failovers:
            raise RuntimeError(
                f"supervisor exceeded {self.max_failovers} failovers "
                f"(last cause: {cause})")
        t_detect = self._clock()
        # disarm the failed engine's hook, so a lingering reference cannot
        # keep consuming the plan's occurrence schedule
        self.engine.executor.launch_hook = None
        t0 = self._clock()
        self.engine = self.factory()
        rebuild_s = self._clock() - t0
        # restore loads the snapshot's registry state whole; when the
        # engines keep registries of their own, that state may hold an
        # older copy of this supervisor's failover stream and recovery
        # histogram, so both are kept across it
        rows = list(self.failover_events.rows)
        hist = self.recovery_ms.state_dict()
        t0 = self._clock()
        self.engine.restore(snap)
        replay_s = self._clock() - t0
        self.failover_events.rows = deque(rows,
                                          maxlen=self.failover_events.rows.maxlen)
        self.recovery_ms.load_state(hist)
        self.engine.check_paged_invariants()
        self._arm()
        recovery_ms = (rebuild_s + replay_s) * 1e3
        self.recovery_ms.observe(recovery_ms)
        if self._policy is not None:
            self._policy.controller = self.engine.ctrl
            note = getattr(self._policy, "note_failover", None)
            if note is not None:
                note(recovery_ms=recovery_ms)
        entry = dict(step=self.engine.step_count, cause=cause,
                     detect_s=detect_s, rebuild_s=rebuild_s,
                     replay_s=replay_s, first_token_s=None)
        self.failover_events.append(entry)
        self._pending_first_token = (entry, t_detect)

    def tick(self, now_s: float = 0.0) -> float:
        """One supervised tick: snapshot, attempt, recover, redo. Returns
        the successful attempt's measured device time (the virtual clock
        advances by served work only; recovery is in ``failover_log``)."""
        snap = self.engine.snapshot()
        while True:
            gen0 = self.engine._generated_total()
            t0 = self._clock()
            try:
                dt = self.engine.step(now_s=now_s)
            except self.recover_on as e:
                self._failover(snap, f"{type(e).__name__}: {e}",
                               self._clock() - t0)
                continue
            wall = self._clock() - t0
            # a clock's verdict: every rank of a mesh takes rank 0's
            if self.tick_timeout_s is not None and self.engine.executor.agree(
                    wall > self.tick_timeout_s):
                self._failover(
                    snap, f"tick wall time {wall:.3f}s exceeded timeout "
                          f"{self.tick_timeout_s}s", wall)
                continue
            break
        if (self._pending_first_token is not None
                and self.engine._generated_total() > gen0):
            entry, t_detect = self._pending_first_token
            entry["first_token_s"] = self._clock() - t_detect
            self._pending_first_token = None
        return dt

    def run_trace(self, trace: Sequence[Any], *,
                  budget_fn: Optional[Callable[[float], float]] = None,
                  policy=None, max_steps: int = 100_000) -> Dict[str, Any]:
        """Drive an arrival trace through supervised ticks (virtual clock):
        the supervised mirror of ``ServingEngine.run``. ``self.engine`` is
        read again every iteration, since a failover swaps it."""
        if (policy is None) != (budget_fn is None):
            raise ValueError("policy and budget_fn must be passed together")
        if policy is not None:
            self.attach_policy(policy)
        pending: Deque[Any] = deque(sorted(trace, key=lambda r: r.arrival_s))
        clock = 0.0
        busy = 0.0
        eng = self.engine
        completed0 = len(eng.completed)
        expired0 = len(eng.expired)
        generated0 = eng._generated_total()
        steps0 = eng.step_count
        bp0 = eng.backpressure_events
        failovers0 = self.failovers
        log0 = len(self.failover_log)
        while True:
            eng = self.engine
            if not ((pending or eng.queue or eng.n_active)
                    and eng.step_count - steps0 < max_steps):
                break
            while pending and pending[0].arrival_s <= clock:
                eng.submit(pending.popleft())
            if not eng.queue and not eng.n_active:
                clock = pending[0].arrival_s
                continue
            if policy is not None and budget_fn is not None:
                qd = {c: len(q) for c, q in eng._queues.items()}
                mode = policy.choose(budget_fn(clock), queue_depths=qd)
                if mode.name != eng.admission_mode.name:
                    eng.admission_decision_log.append(
                        dict(step=eng.step_count, **policy.last_decision))
                eng.set_admission_mode(mode)
                if eng.speculative is not None:
                    eng._retune_spec(policy, qd)
            # the virtual clock decides admissions: rank 0's on a mesh
            dt = self.engine.executor.agree(self.tick(now_s=clock))
            busy += dt
            clock += dt
        eng = self.engine
        total_generated = eng._generated_total() - generated0
        new_log = self.failover_log[log0:]
        return {
            "completed": len(eng.completed) - completed0,
            "expired": len(eng.expired) - expired0,
            "generated_tokens": total_generated,
            "busy_s": busy,
            "clock_s": clock,
            "sustained_tokens_per_s":
                total_generated / busy if busy > 0 else 0.0,
            "failovers": self.failovers - failovers0,
            "recovery_s": [e["rebuild_s"] + e["replay_s"] for e in new_log],
            "first_token_s": [e["first_token_s"] for e in new_log],
            "backpressure_events": eng.backpressure_events - bp0,
        }
