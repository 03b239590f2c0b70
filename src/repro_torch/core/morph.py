"""NeuroMorph runtime controller — mode switching without redeployment.

Port of ``repro.core.morph``. On the FPGA, NeuroMorph toggles clock gates to
activate a subnetwork; nothing is reprogrammed. Here:

* **Width is a runtime operand.** ``make_serve_controller`` builds ONE
  decode step callable per *depth*; each takes the full params, a
  full-width per-slot cache (updated in place) and an ``active`` dict of
  per-slot (B,) width tensors that the ``morph_matmul`` and fused decode
  kernels read on the card. A width switch is a different tensor value.
* **Depth picks the step.** Depth sets the length of the layer loop, so
  ``compile_key`` groups modes by depth. PyTorch runs eagerly, so there is
  no jit: "compiling" a key means building its step callable at warmup,
  counted in ``stats["compiles"]`` and in ``trace_counter`` — after warmup,
  width churn builds nothing new.

``MorphController`` records switch telemetry (build count, dispatch count,
per-mode latency percentiles) and keeps the auxiliary steps
(``register_aux`` / ``aux_step``): the speculative draft and verify steps,
and, over a block-paged cache, one decode step per (depth, page-table
width bucket), keyed by ``paged_decode_compile_key``. The online
autoscaler (``runtime.autoscale``) builds more of them after warmup from
``aux_builders``, installs them with ``publish_aux`` and evicts cold ones
with ``unregister_aux``, reading ``coldness``.
"""
from __future__ import annotations

import bisect
import time
from collections import deque
from typing import Callable, Deque, Dict, Hashable, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, MorphMode
from repro_torch.core import elastic
from repro_torch.models.model import decode_step


def paged_decode_compile_key(depth: int, bucket: int) -> Tuple:
    """Key of the paged one-token decode step for one (depth, page-table
    width bucket); disjoint from the per-depth dense keys and the
    speculative keys."""
    return ("paged_decode", depth, bucket)


def _block_until_ready(out) -> None:
    """Wait for the calling thread's current stream to finish the work
    behind ``out`` (a tensor or a tuple/dict holding tensors); a no-op for
    CPU tensors. Only that stream: work another thread queued on a stream
    of its own (the autoscaler's background warm-up) is not waited for, as
    ``jax.block_until_ready`` waits for ``out`` alone."""
    stack = [out]
    while stack:
        o = stack.pop()
        if isinstance(o, torch.Tensor):
            if o.is_cuda:
                torch.cuda.current_stream(o.device).synchronize()
            return
        if isinstance(o, dict):
            stack.extend(o.values())
        elif isinstance(o, (tuple, list)):
            stack.extend(reversed(o))


class ModeTelemetry:
    """Online per-mode step-latency / throughput statistics.

    Latencies are kept sorted in a bounded window: percentile queries are
    O(1); recording is O(window) worst case (sorted-list insert/evict) —
    trivial at serving tick rates with the default window of 512.
    ``tokens_per_s`` is aggregate over everything recorded.
    """

    def __init__(self, window: int = 512):
        self._window = window
        self._sorted: List[float] = []  # sorted latencies, bounded
        self._fifo: Deque[float] = deque()  # same values in arrival order
        self.steps = 0
        self.tokens = 0
        self.total_s = 0.0

    def record(self, dt_s: float, tokens: int = 0) -> None:
        self.steps += 1
        self.tokens += tokens
        self.total_s += dt_s
        bisect.insort(self._sorted, dt_s)
        self._fifo.append(dt_s)
        if len(self._fifo) > self._window:
            old = self._fifo.popleft()
            self._sorted.pop(bisect.bisect_left(self._sorted, old))

    def _quantile(self, q: float) -> float:
        if not self._sorted:
            return 0.0
        i = min(len(self._sorted) - 1, int(q * len(self._sorted)))
        return self._sorted[i]

    @property
    def p50_s(self) -> float:
        return self._quantile(0.50)

    @property
    def p95_s(self) -> float:
        return self._quantile(0.95)

    @property
    def p99_s(self) -> float:
        return self._quantile(0.99)

    @property
    def tokens_per_s(self) -> float:
        return self.tokens / self.total_s if self.total_s > 0 else 0.0

    def summary(self) -> Dict[str, float]:
        return {"steps": self.steps, "tokens": self.tokens,
                "p50_ms": self.p50_s * 1e3, "p95_ms": self.p95_s * 1e3,
                "p99_ms": self.p99_s * 1e3,
                "tokens_per_s": self.tokens_per_s}

    def state_dict(self) -> Dict:
        """Copy of the full telemetry state (plain lists and scalars): the
        snapshot/restore seam of fault-tolerant serving, so a rebuilt engine
        keeps steering the SLO policy with the measured history of the
        engine it replaces."""
        return {"window": self._window, "fifo": list(self._fifo),
                "steps": self.steps, "tokens": self.tokens,
                "total_s": self.total_s}

    def load_state(self, st: Dict) -> None:
        self._window = int(st["window"])
        self._fifo = deque(st["fifo"])
        self._sorted = sorted(self._fifo)
        self.steps = int(st["steps"])
        self.tokens = int(st["tokens"])
        self.total_s = float(st["total_s"])


class MorphController:
    """Dispatches train/serve steps to specialized executables.

    ``compile_key`` maps a mode to its executable's cache key: the default
    (mode name) specializes per mode; the serving controller passes
    ``lambda m: m.depth`` so all width modes of a depth share one executable
    (width arrives as a runtime operand instead).
    """

    def __init__(self, cfg: ModelConfig, step_factory: Callable[[MorphMode], Callable],
                 modes: Optional[Tuple[MorphMode, ...]] = None,
                 compile_key: Callable[[MorphMode], Hashable] = lambda m: m.name):
        self.cfg = cfg
        self.modes = tuple(modes or cfg.elastic.modes(cfg.n_groups))
        self.mode_by_name = {m.name: m for m in self.modes}
        self._factory = step_factory
        self._compile_key = compile_key
        self._compiled: Dict[Hashable, Callable] = {}
        # auxiliary steps (speculative draft / verify), keyed by tuples
        # disjoint from the per-depth decode keys
        self._aux_factories: Dict[Hashable, Callable[[], Callable]] = {}
        # builder kinds the serving wiring exposes for registration after
        # warmup (the autoscaler's frontier points); make_serve_controller
        self.aux_builders: Dict[str, Callable] = {}
        # dispatch count at each step's last use: the autoscaler's coldness
        # signal for evicting from the table
        self.last_dispatch: Dict[Hashable, int] = {}
        self.stats = {"compiles": 0, "dispatches": 0, "switches": 0}
        self.telemetry: Dict[str, ModeTelemetry] = {m.name: ModeTelemetry()
                                                   for m in self.modes}
        # per-set_mode-change structured event stream; bounded for long
        # serves. Imported here: the serving runtime imports this module.
        from repro_torch.runtime.observability import EventStream
        self.switch_events = EventStream(
            "controller_mode_switch", ("dispatch", "from_mode", "to_mode"))
        self.last_step_s = 0.0  # latency of the most recent timed_step
        # injectable for deterministic tests / virtual-clock supervision
        # (the serving engine points it at its Observability clock)
        self.clock: Callable[[], float] = time.perf_counter
        self._mode = self.modes[-1]  # full model by default

    @property
    def switch_log(self):
        """Legacy tuple view of ``switch_events``: (dispatch#, from, to)."""
        from repro_torch.runtime.observability import _TupleView
        return _TupleView(self.switch_events)

    @property
    def mode(self) -> MorphMode:
        return self._mode

    def set_mode(self, mode: MorphMode) -> None:
        if mode.name not in self.mode_by_name:
            raise KeyError(f"mode {mode.name} not in deployed mode table")
        if mode.name != self._mode.name:
            self.stats["switches"] += 1
            self.switch_events.emit(dispatch=self.stats["dispatches"],
                                    from_mode=self._mode.name,
                                    to_mode=mode.name)
        self._mode = mode

    def _get(self, mode: MorphMode) -> Callable:
        key = self._compile_key(mode)
        fn = self._compiled.get(key)
        if fn is None:
            fn = self._factory(mode)
            self._compiled[key] = fn
            self.stats["compiles"] += 1
        self.last_dispatch[key] = self.stats["dispatches"]
        return fn

    def register_aux(self, key: Hashable, factory: Callable[[], Callable]) -> None:
        """Register an auxiliary step (built at warmup or first use): one
        draft per (draft_depth, K) and one verify per (depth, K). Keys name
        steps, not variants: registering one twice is an error."""
        if key in self._aux_factories or key in self._compiled:
            raise KeyError(f"aux executable {key!r} already registered")
        self._aux_factories[key] = factory

    def aux_step(self, key: Hashable) -> Callable:
        """The auxiliary step for ``key``, built on first use and counted in
        ``stats['compiles']`` like any mode step."""
        fn = self._compiled.get(key)
        if fn is None:
            fn = self._aux_factories[key]()
            self._compiled[key] = fn
            self.stats["compiles"] += 1
        self.last_dispatch[key] = self.stats["dispatches"]
        return fn

    def publish_aux(self, key: Hashable, fn: Callable,
                    factory: Optional[Callable[[], Callable]] = None) -> None:
        """Install an auxiliary step that was ALREADY built and warmed.

        The autoscaler's publish-then-swap seam: a background thread builds
        and warms ``fn``, then the serving thread installs it with two dict
        assignments, so no build lands on a serving tick. Counted in
        ``stats['compiles']`` (the build happened, only elsewhere);
        ``factory`` keeps a rebuild path for a later warmup."""
        if key in self._aux_factories or key in self._compiled:
            raise KeyError(f"aux executable {key!r} already registered")
        self._aux_factories[key] = (factory if factory is not None
                                    else (lambda: fn))
        self._compiled[key] = fn
        self.stats["compiles"] += 1
        self.last_dispatch[key] = self.stats["dispatches"]

    def unregister_aux(self, key: Hashable) -> None:
        """Retire an auxiliary step: drop its factory and its built step
        (eviction is explicit, since ``register_aux`` refuses a key twice).
        The mode table is not evictable; ``stats['compiles']`` stays
        monotone."""
        if key not in self._aux_factories:
            raise KeyError(f"aux executable {key!r} is not registered")
        del self._aux_factories[key]
        self._compiled.pop(key, None)
        self.last_dispatch.pop(key, None)

    @property
    def compile_table_size(self) -> int:
        """Live built steps (modes + aux)."""
        return len(self._compiled)

    def compiled_keys(self) -> Tuple[Hashable, ...]:
        return tuple(self._compiled)

    def aux_keys(self) -> Tuple[Hashable, ...]:
        """Registered auxiliary keys (the evictable part of the table)."""
        return tuple(self._aux_factories)

    def coldness(self, key: Hashable) -> int:
        """Dispatches since ``key`` was last used (0 = hot)."""
        return self.stats["dispatches"] - self.last_dispatch.get(key, 0)

    def warmup(self) -> None:
        """Build every distinct step (the deploy-time 'single bitstream'):
        modes sharing a compile key share one build, then every registered
        auxiliary step."""
        for m in self.modes:
            self._get(m)
        for key in self._aux_factories:
            self.aux_step(key)

    def __call__(self, *args, **kw):
        self.stats["dispatches"] += 1
        return self._get(self._mode)(*args, **kw)

    def timed_step(self, *args, mode: Optional[MorphMode] = None, tokens: int = 0,
                   **kw):
        """Dispatch one step, block on the result, record telemetry.

        ``mode`` dispatches a specific executable WITHOUT going through
        ``set_mode``: a serving engine interleaving draining mode groups is
        not making policy decisions, and must not inflate the switch
        counter/log. ``tokens`` is the number of useful tokens this step
        produced (active batch slots), feeding ``tokens_per_s``. The measured
        latency is the online correction signal an SLO policy blends with
        the analytical estimate.
        """
        m = self._mode if mode is None else mode
        self.stats["dispatches"] += 1
        t0 = self.clock()
        out = self._get(m)(*args, **kw)
        _block_until_ready(out)
        dt = self.clock() - t0
        self.telemetry[m.name].record(dt, tokens)
        self.last_step_s = dt
        return out

    def step_for(self, mode: MorphMode) -> Callable:
        return self._get(mode)

    def force_mode(self, mode: MorphMode) -> None:
        """Set the active mode WITHOUT counting or logging a switch: a
        snapshot restore re-applies a decision the lost engine already made
        and logged, which ``set_mode`` would count twice."""
        if mode.name not in self.mode_by_name:
            raise KeyError(f"mode {mode.name} not in deployed mode table")
        self._mode = mode

    def telemetry_summary(self) -> Dict[str, Dict[str, float]]:
        return {name: t.summary() for name, t in self.telemetry.items()
                if t.steps}

    def telemetry_state(self) -> Dict[str, Dict]:
        """Per-mode telemetry for a snapshot (``ModeTelemetry.state_dict``)."""
        return {name: t.state_dict() for name, t in self.telemetry.items()}

    def load_telemetry_state(self, st: Dict[str, Dict]) -> None:
        for name, s in st.items():
            if name in self.telemetry:
                self.telemetry[name].load_state(s)


def make_serve_controller(params, cfg: ModelConfig,
                          modes: Optional[Tuple[MorphMode, ...]] = None, *,
                          mesh=None, shard=None, speculative=None,
                          paged_page_size: int = 0,
                          paged_buckets: Tuple[int, ...] = (),
                          fused: bool = False) -> MorphController:
    """Serving controller: ONE decode step callable per *depth*.

    Each step's signature is ``step(params, cache, tokens, active)`` ->
    ``(logits, cache)``: full params, a FULL-width per-slot cache (updated in
    place), and ``active`` per-slot width tensors from
    ``elastic.active_widths_batch``. The same step serves every width, and
    one launch may mix widths across slots. ``ctrl.trace_counter["n"]``
    advances only when a step is built — the zero-rebuild invariant.

    ``speculative`` (a ``SpecConfig``) adds, through ``register_aux``, one
    draft step per (draft_depth, K) and one verify step per (depth, K) of
    ``ctrl.spec_plan``, and for its token trees one tree draft step per
    (draft_depth, branching) and one tree verify step per (depth,
    branching); they are built at warmup and advance ``trace_counter``
    once each. The tree draft takes the einsum attention path in fused
    engines too (as the reference's does); the tree verify is fused.

    ``paged_page_size`` > 0 switches the serving surface to the block-paged
    cache (``models.paged``): every step takes a trailing page-table
    operand, the one-token decode is keyed ``("paged_decode", depth,
    bucket)`` for every table width in ``paged_buckets`` (slots whose page
    counts fall in one bucket share one step), and the draft and verify
    steps read the pool through the full-width table. The per-depth dense
    steps stay registered, but a paged engine dispatches the bucketed keys.
    Every paged step plans the fused kernels' splits for the widest bucket
    (a slot's full capacity), so each bucket visits a slot's rows as the
    dense cache does.

    ``fused=True`` routes every attention decode and verify through the
    fused kernels; it is a closure flag, so compile keys are unchanged.

    ``mesh`` (a ``DeviceMesh``) with ``shard`` (this rank's
    ``tensor_parallel.ShardComm``) builds the same steps for one rank of a
    (data, model) mesh: each runs on the shard-local config and is wrapped
    in a ``tensor_parallel.MeshStep`` (per-slot operands cut to the rank's
    slots, widths localized, the collectives on, per-slot results gathered
    over ``data``). The compile keys, ``trace_counter`` and the build
    count are those of the local path.
    """
    if (mesh is None) != (shard is None):
        raise ValueError("a mesh controller needs both the mesh and this "
                         "rank's shard")
    if shard is not None:
        from repro_torch.parallel.tensor_parallel import MeshStep

        cfg_l = shard.shard.cfg

        def wrap(fn):
            return MeshStep(fn, shard)
    else:
        cfg_l = cfg

        def wrap(fn):
            return fn
    if paged_page_size and not paged_buckets:
        raise ValueError("paged serving needs its page-table buckets")
    plan_len = max(paged_buckets, default=0) * paged_page_size
    trace_counter = {"n": 0}

    def factory(mode: MorphMode):
        depth = mode.depth
        trace_counter["n"] += 1  # runs once per built step

        def step(p, cache, tokens, active):
            return decode_step(p, cache, tokens, cfg_l, depth=depth,
                               active=active, fused=fused)

        return wrap(step)

    ctrl = MorphController(cfg, factory, modes, compile_key=lambda m: m.depth)
    ctrl.trace_counter = trace_counter
    ctrl.spec_plan = {}
    if paged_page_size:
        def paged_factory(depth: int, bucket: int):
            def build():
                trace_counter["n"] += 1

                def step(p, cache, tokens, active, pages):
                    return decode_step(p, cache, tokens, cfg_l, depth=depth,
                                       active=active, pages=pages,
                                       page_size=paged_page_size,
                                       plan_len=plan_len, fused=fused)

                return wrap(step)
            return build

        ctrl.aux_builders["paged_decode"] = paged_factory
        for d in sorted({m.depth for m in ctrl.modes}):
            for b in paged_buckets:
                ctrl.register_aux(paged_decode_compile_key(d, b),
                                  paged_factory(d, b))
    if speculative is not None:
        # local import: the speculative module imports the model, and the
        # serving runtime imports this module
        from repro_torch.runtime import speculative as _spec

        plan = _spec.spec_plan([m.depth for m in ctrl.modes], speculative)
        ctrl.spec_plan = plan
        top_k = speculative.top_k

        def draft_factory(draft_depth: int, k: int):
            def build():
                trace_counter["n"] += 1
                return wrap(_spec.make_draft_step(
                    cfg_l, draft_depth, k, top_k, page_size=paged_page_size,
                    plan_len=plan_len, fused=fused))
            return build

        def verify_factory(depth: int, k: int):
            def build():
                trace_counter["n"] += 1
                return wrap(_spec.make_verify_step(
                    cfg_l, depth, k, top_k, page_size=paged_page_size,
                    plan_len=plan_len, fused=fused))
            return build

        def tree_draft_factory(draft_depth: int, branching):
            def build():
                trace_counter["n"] += 1
                return wrap(_spec.make_tree_draft_step(
                    cfg_l, draft_depth, branching, top_k,
                    page_size=paged_page_size))
            return build

        def tree_verify_factory(depth: int, branching):
            def build():
                trace_counter["n"] += 1
                return wrap(_spec.make_tree_verify_step(
                    cfg_l, depth, branching, top_k,
                    page_size=paged_page_size, plan_len=plan_len,
                    fused=fused))
            return build

        # the factory kinds, for the autoscaler to build frontier points
        # no warmup built: the same closures, installed through
        # publish_aux after a background build instead of register_aux
        ctrl.aux_builders.update(
            draft=draft_factory, verify=verify_factory,
            tree_draft=tree_draft_factory, tree_verify=tree_verify_factory)
        for dd, k in sorted({(e.draft_depth, k) for e in plan.values()
                             for k in e.ks}):
            ctrl.register_aux(_spec.draft_compile_key(dd, k),
                              draft_factory(dd, k))
        for dd, br in sorted({(e.draft_depth, br) for e in plan.values()
                              for br in e.trees}):
            ctrl.register_aux(_spec.tree_draft_compile_key(dd, br),
                              tree_draft_factory(dd, br))
        for e in plan.values():
            for k in e.ks:
                ctrl.register_aux(_spec.verify_compile_key(e.depth, k),
                                  verify_factory(e.depth, k))
            for br in e.trees:
                ctrl.register_aux(_spec.tree_verify_compile_key(e.depth, br),
                                  tree_verify_factory(e.depth, br))
    return ctrl


def policy_for_budget(cfg: ModelConfig, controller: MorphController,
                      latency_budget_s: float, est_latency: Callable[[MorphMode], float]) -> MorphMode:
    """Pick the most accurate mode fitting a latency budget (paper's runtime
    trade-off loop: accuracy vs latency/power under changing constraints).

    Modes are ranked by active-FLOPs fraction (proxy for accuracy retention,
    monotone under DistillCycle); the largest mode whose estimated latency
    fits is selected.
    """
    ranked = sorted(controller.modes, key=lambda m: elastic.flops_fraction(cfg, m))
    best = ranked[0]
    for m in ranked:
        if est_latency(m) <= latency_budget_s:
            best = m
    return best
