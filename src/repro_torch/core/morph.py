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
per-mode latency percentiles).
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


def _block_until_ready(out) -> None:
    """Wait for the card to finish the work behind ``out`` (a tensor or a
    tuple/dict holding tensors); a no-op for CPU tensors."""
    stack = [out]
    while stack:
        o = stack.pop()
        if isinstance(o, torch.Tensor):
            if o.is_cuda:
                torch.cuda.synchronize(o.device)
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
        return fn

    def warmup(self) -> None:
        """Pre-compile every distinct executable (the deploy-time 'single
        bitstream'); modes sharing a compile key share one compile."""
        for m in self.modes:
            self._get(m)

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

    def telemetry_summary(self) -> Dict[str, Dict[str, float]]:
        return {name: t.summary() for name, t in self.telemetry.items()
                if t.steps}


def make_serve_controller(params, cfg: ModelConfig,
                          modes: Optional[Tuple[MorphMode, ...]] = None, *,
                          mesh=None, speculative=None,
                          paged_page_size: int = 0,
                          fused: bool = False) -> MorphController:
    """Serving controller: ONE decode step callable per *depth*.

    Each step's signature is ``step(params, cache, tokens, active)`` ->
    ``(logits, cache)``: full params, a FULL-width per-slot cache (updated in
    place), and ``active`` per-slot width tensors from
    ``elastic.active_widths_batch``. The same step serves every width, and
    one launch may mix widths across slots. ``ctrl.trace_counter["n"]``
    advances only when a step is built — the zero-rebuild invariant.

    ``fused=True`` routes every attention decode through the fused decode
    kernels; it is a closure flag, so compile keys are unchanged. Mesh
    executors, speculative decoding and paged caches arrive with later
    slices of the port and raise here.
    """
    if mesh is not None:
        raise NotImplementedError("mesh serving arrives with the multi-device "
                                  "slice of the port")
    if speculative is not None:
        raise NotImplementedError("speculative serving arrives with the "
                                  "speculative slice of the port")
    if paged_page_size:
        raise NotImplementedError("paged KV serving arrives with the paged "
                                  "slice of the port")
    trace_counter = {"n": 0}

    def factory(mode: MorphMode):
        depth = mode.depth
        trace_counter["n"] += 1  # runs once per built step

        def step(p, cache, tokens, active):
            return decode_step(p, cache, tokens, cfg, depth=depth,
                               active=active, fused=fused)

        return step

    ctrl = MorphController(cfg, factory, modes, compile_key=lambda m: m.depth)
    ctrl.trace_counter = trace_counter
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
