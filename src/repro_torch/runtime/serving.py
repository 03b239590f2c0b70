"""Continuous-batching NeuroMorph serving engine.

Port of ``repro.runtime.serving`` for the slice the port covers: a dense
per-slot KV cache, greedy one-token decode, prefill admission, per-depth
slot groups with mixed per-slot widths, SLO-driven admission and
observability.

* **Request queue + slot admission.** Requests wait in a two-level queue
  (``interactive`` before ``batch``) and are admitted into free slots every
  tick. A whole admission burst is rewound by one ``reset_cache_slots``.
* **Per-DEPTH slot groups; width is per-slot data.** Each distinct depth is
  one step callable and one slot group with one full-width cache. Every slot
  keeps the width it was admitted at; each tick lowers the widths to
  per-slot (B,) tensors on the card (``elastic.active_widths_batch``) that
  the ``morph_matmul`` and fused decode kernels read, so a tick with three
  widths in flight at one depth issues ONE decode step.
* **Prefill admission.** Prompts of at least ``prefill_threshold`` tokens
  are consumed by one ``prefill(per_slot=True, slot=..., n_slots=...)``
  call whose cache is adopted into the slot (``adopt_cache_slot``).
* **SLO-driven morph policy.** ``SLOPolicy`` picks the widest/deepest mode
  whose predicted step latency fits the budget: the analytical estimate on
  the port's hardware spec (H100 data-sheet peaks), corrected online by
  measured per-mode telemetry.

``fused=True`` routes every attention layer through the fused decode
kernels (a closure flag on the step callables). Paged caches, speculative
decoding, sampling (``temperature > 0``), snapshot/restore and mesh
executors arrive with later slices of the port and raise here.
"""
from __future__ import annotations

import statistics
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, MorphMode, ShapeCell
from repro_torch.core import elastic
from repro_torch.core.morph import (MorphController, _block_until_ready,
                                    make_serve_controller, policy_for_budget)
from repro_torch.core.neuroforge.analytical import estimate_mode
from repro_torch.core.neuroforge.hw import DEFAULT_HW, HardwareSpec
from repro_torch.core.neuroforge.space import DesignPoint
from repro_torch.device import resolve_device
from repro_torch.models.model import (adopt_cache_slot, init_decode_cache,
                                      prefill, reset_cache_slots)
from repro_torch.runtime.observability import Observability, _TupleView

SLO_CLASSES = ("interactive", "batch")


# ---------------------------------------------------------------------------
# requests and traces
# ---------------------------------------------------------------------------


@dataclass
class Request:
    """One inference request: feed ``prompt`` then generate ``max_new_tokens``."""

    rid: int
    prompt: Tuple[int, ...]
    max_new_tokens: int
    arrival_s: float = 0.0
    slo_class: str = "batch"  # "interactive" admits ahead of "batch"
    # absolute deadline: still queued past this instant -> retired with the
    # terminal "expired" status instead of starving silently (None = no TTL)
    deadline_s: Optional[float] = None
    # runtime state (engine-owned)
    generated: List[int] = field(default_factory=list)
    fed: int = 0  # tokens fed so far (prompt + generated)
    mode_name: str = ""
    admitted_step: int = -1
    finished_s: float = -1.0
    status: str = "queued"  # queued | active | done | expired
    prefilled: bool = False  # admitted through the prefill path

    @property
    def done(self) -> bool:
        return len(self.generated) >= self.max_new_tokens

    def next_input(self) -> int:
        """Token to feed this step: prompt first, then the last sample."""
        if self.fed < len(self.prompt):
            return self.prompt[self.fed]
        return self.generated[-1] if self.generated else self.prompt[-1]


def poisson_trace(n_requests: int, rate_per_s: float, *, seed: int = 0,
                  prompt_len: Tuple[int, int] = (1, 4),
                  new_tokens: Tuple[int, int] = (4, 12),
                  vocab: int = 256,
                  interactive_frac: float = 0.0) -> List[Request]:
    """Poisson arrivals with uniform prompt/output lengths (open-loop trace).

    Draws the same numpy stream as ``repro.runtime.serving.poisson_trace``,
    so one seed gives one trace in both packages."""
    rng = np.random.default_rng(seed)
    t = 0.0
    out = []
    for i in range(n_requests):
        t += float(rng.exponential(1.0 / rate_per_s))
        plen = int(rng.integers(prompt_len[0], prompt_len[1] + 1))
        out.append(Request(
            rid=i,
            prompt=tuple(int(x) for x in rng.integers(1, vocab, plen)),
            max_new_tokens=int(rng.integers(new_tokens[0], new_tokens[1] + 1)),
            arrival_s=t,
            slo_class=("interactive" if rng.random() < interactive_frac
                       else "batch"),
        ))
    return out


# ---------------------------------------------------------------------------
# SLO-driven morph policy
# ---------------------------------------------------------------------------


class SLOPolicy:
    """Pick the widest mode whose predicted step latency fits the budget.

    Prediction = analytical roofline estimate (``neuroforge.analytical`` on
    ``hw``, the H100 data sheet by default) scaled by an online correction
    learned from the controller's per-mode telemetry. Once a mode has
    ``min_samples`` measured steps its own p50 is used directly, and the
    measured/analytical ratio of observed modes corrects the rest.
    """

    def __init__(self, cfg: ModelConfig, controller: MorphController, *,
                 batch_size: int, cache_capacity: int,
                 hw: HardwareSpec = DEFAULT_HW, min_samples: int = 3,
                 queue_gamma: float = 0.25,
                 interactive_weight: float = 2.0):
        self.cfg = cfg
        self.controller = controller
        self.min_samples = min_samples
        self.batch_size = batch_size
        # budget-aware admission: how strongly queue depth squeezes the
        # effective latency budget (0 disables), and how much heavier a
        # queued interactive request weighs than a batch one
        self.queue_gamma = queue_gamma
        self.interactive_weight = interactive_weight
        self.last_decision: Dict[str, float] = {}
        cell = ShapeCell("serve_step", seq_len=cache_capacity,
                         global_batch=batch_size, kind="decode")
        # one card: no data or tensor parallelism until the mesh slice
        pt = DesignPoint(dp=1, tp=1, microbatches=1, remat="none",
                         param_dtype=cfg.param_dtype
                         if cfg.param_dtype in ("bfloat16", "float32") else "bfloat16",
                         moment_dtype="float32", grad_comm="allreduce",
                         kv_quant=cfg.kv_quant, attn_chunk=cfg.attn_chunk,
                         capacity_factor=cfg.capacity_factor, width=1.0)
        self.design_point = pt
        self._cell = cell
        self._hw = hw
        self.analytical: Dict[str, float] = {}
        for m in controller.modes:
            self.analytical[m.name] = self._analytical_for(m)

    def _analytical_for(self, mode: MorphMode) -> float:
        a = self.analytical.get(mode.name)
        if a is None:
            a = estimate_mode(self.cfg, self._cell, self.design_point,
                              depth=mode.depth, width=mode.width,
                              hw=self._hw).latency_s
            self.analytical[mode.name] = a
        return a

    def _correction(self) -> float:
        ratios = []
        for name, t in self.controller.telemetry.items():
            a = self.analytical.get(name, 0.0)
            if t.steps >= self.min_samples and a > 0:
                ratios.append(t.p50_s / a)
        return statistics.median(ratios) if ratios else 1.0

    def est_latency(self, mode: MorphMode) -> float:
        t = self.controller.telemetry.get(mode.name)
        if t is not None and t.steps >= self.min_samples:
            return t.p50_s
        return self._analytical_for(mode) * self._correction()

    def _queue_pressure(self, queue_depths: Optional[Dict[str, int]]) -> float:
        """Weighted queued-request count per batch slot (0 = empty queue)."""
        if not queue_depths:
            return 0.0
        w = sum((self.interactive_weight if c == "interactive" else 1.0) * n
                for c, n in queue_depths.items())
        return w / max(self.batch_size, 1)

    def choose(self, budget_s: float,
               queue_depths: Optional[Dict[str, int]] = None) -> MorphMode:
        """Admission mode for a latency budget, weighed against the queue:
        a deep queue means admitted requests also pay queueing delay, so the
        effective budget is ``budget / (1 + queue_gamma * pressure)``. The
        post-failover catch-up squeeze arrives with the robustness slice."""
        pressure = self._queue_pressure(queue_depths)
        eff = budget_s / (1.0 + self.queue_gamma * pressure)
        mode = policy_for_budget(self.cfg, self.controller, eff,
                                 self.est_latency)
        self.last_decision = {
            "budget_s": budget_s, "effective_budget_s": eff,
            "queue_pressure": pressure, "mode": mode.name,
            "queued_interactive": (queue_depths or {}).get("interactive", 0),
            "queued_batch": (queue_depths or {}).get("batch", 0),
        }
        return mode


# ---------------------------------------------------------------------------
# executor seam — where device placement and step building live
# ---------------------------------------------------------------------------


class LocalExecutor:
    """Single-device execution backend (the card unless told otherwise).

    The engine delegates every device decision to its executor: parameter
    placement, per-depth controller building, cache allocation, and the
    cache-side ops (batched slot reset, prefill, prefill adoption).
    ``launch_hook`` is the one seam every launch boundary announces itself
    through ("decode", "prefill"), shared by tracing and failure injection.
    """

    mesh = None
    policy = "local"
    dp = 1
    tp = 1
    launch_hook: Optional[Callable[[str], None]] = None

    def __init__(self, device=None):
        self.device = resolve_device(device)

    def launch(self, site: str) -> None:
        """Announce a launch boundary to the installed hook, if any."""
        if self.launch_hook is not None:
            self.launch_hook(site)

    def bind(self, cfg: ModelConfig, batch_size: int, cache_capacity: int,
             paged=None, fused: bool = False) -> "LocalExecutor":
        if paged is not None:
            raise NotImplementedError("paged KV serving arrives with the paged "
                                      "slice of the port")
        self._cfg = cfg
        self._batch = batch_size
        self._cap = cache_capacity
        self._fused = fused
        return self

    # -- placement ----------------------------------------------------------

    def place_params(self, params):
        def move(t):
            if isinstance(t, dict):
                return {k: move(v) for k, v in t.items()}
            return t.to(self.device)
        return move(params)

    def put(self, x) -> torch.Tensor:
        """Small operand (tokens / widths / reset masks) onto the device."""
        return torch.as_tensor(np.asarray(x), device=self.device)

    # -- device ops ---------------------------------------------------------

    def make_controller(self, params, cfg: ModelConfig, modes,
                        speculative=None) -> MorphController:
        return make_serve_controller(params, cfg, modes,
                                     speculative=speculative,
                                     fused=self._fused)

    def init_cache(self):
        return init_decode_cache(self._cfg, self._batch, self._cap,
                                 per_slot=True, device=self.device)

    def reset_fn(self):
        """Batched slot rewind, in place on the cache."""
        return reset_cache_slots

    def adopt_fn(self):
        return adopt_cache_slot

    def prefill_fn(self, prompt_len: int, depth: int):
        """Whole-prompt consume: (params, (1, L) tokens, slot) ->
        (last-token logits, engine-layout cache with only ``slot`` live)."""
        cfg, cap, n_slots = self._cfg, self._cap, self._batch

        def pf(params, tokens, slot):
            return prefill(params, {"tokens": tokens}, cfg,
                           cache_extra=cap - prompt_len, per_slot=True,
                           slot=slot, n_slots=n_slots, depth=depth)

        return pf


@dataclass
class _DepthGroup:
    """One depth's slots: its full-width cache and the width fraction each
    occupant was admitted at."""

    depth: int
    cache: Dict
    slots: List[Optional[Request]]
    widths: List[float]  # admission width per slot (stale for free slots)

    @property
    def n_active(self) -> int:
        return sum(r is not None for r in self.slots)

    def free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.slots) if r is None]


class ServingEngine:
    """Continuous-batching decode engine over a per-depth MorphController.

    One tick = admit queued requests into the admission mode's depth group
    (interactive first; long prompts via one prefill, short ones via one
    batched slot reset), then ONE decode step per depth group with active
    slots — slots of different widths ride the same step via per-slot
    width tensors. The host reads back one argmax per slot per tick.
    """

    _COUNTER_METRICS = {
        "prefills": "engine_prefills",
        "prefill_s": "engine_prefill_s",
        "prefill_prompt_tokens": "engine_prefill_prompt_tokens",
        "decode_launches": "engine_decode_launches",
        "per_mode_launch_equiv": "engine_per_mode_launch_equiv",
        "ticks_with_work": "engine_ticks_with_work",
    }

    def __init__(self, params, cfg: ModelConfig, *, batch_size: int = 4,
                 cache_capacity: int = 64,
                 modes: Optional[Tuple[MorphMode, ...]] = None,
                 controller: Optional[MorphController] = None,
                 executor: Optional[LocalExecutor] = None,
                 prefill_threshold: int = 8,
                 speculative=None,
                 temperature: float = 0.0,
                 paged=None,
                 fused: bool = False,
                 observability: Optional[Observability] = None,
                 device=None):
        if speculative is not None:
            raise NotImplementedError("speculative serving arrives with the "
                                      "speculative slice of the port")
        if temperature > 0:
            raise NotImplementedError("sampled serving (temperature > 0) "
                                      "arrives with the speculative slice of "
                                      "the port")
        if paged is not None:
            raise NotImplementedError("paged KV serving arrives with the paged "
                                      "slice of the port")
        if executor is not None and executor.mesh is not None:
            raise NotImplementedError("mesh executors arrive with the "
                                      "multi-device slice of the port")
        self.cfg = cfg
        self.batch_size = batch_size
        self.cache_capacity = cache_capacity
        # route every attention decode through the fused decode kernels — a
        # closure flag on the step callables: same compile keys
        self.fused = bool(fused)
        self.obs = observability or Observability()
        self.metrics = self.obs.registry
        self._rec = self.obs.recorder
        self._clock = self.obs.clock
        self._counter_objs = {m: self.metrics.counter(m)
                              for m in self._COUNTER_METRICS.values()}
        self._h_prefill = self.metrics.histogram("engine_prefill_ms")
        self._h_decode = self.metrics.histogram("engine_decode_step_ms")
        self.executor = (executor or LocalExecutor(device)).bind(
            cfg, batch_size, cache_capacity, fused=self.fused)
        self.device = self.executor.device
        self.params = self.executor.place_params(params)
        self.ctrl = controller or self.executor.make_controller(
            self.params, cfg, modes)
        self._mode_by_dw = {(m.depth, m.width): m for m in self.ctrl.modes}
        self.groups: Dict[int, _DepthGroup] = {}
        for d in sorted({m.depth for m in self.ctrl.modes}):
            self.groups[d] = _DepthGroup(d, self.executor.init_cache(),
                                         [None] * batch_size,
                                         [1.0] * batch_size)
        reg = self.metrics
        self._ev_admission_switch = reg.events(
            "engine_admission_switch",
            ("step", "from_mode", "to_mode", "queued_interactive",
             "queued_batch", "frontier_gen"))
        self._ev_admission_decision = reg.events(
            "engine_admission_decision",
            ("step", "budget_s", "effective_budget_s", "queue_pressure",
             "mode", "queued_interactive", "queued_batch"))
        reg.attach_events(self.ctrl.switch_events)
        self.ctrl.clock = self._clock
        reg.register_callback(self._metric_gauges, key="engine")
        self._reset = self.executor.reset_fn()
        self._adopt = self.executor.adopt_fn()
        self._prefills: Dict[Tuple[int, int], Callable] = {}
        self.prefill_threshold = prefill_threshold
        self.prefills = 0
        self.prefill_s = 0.0
        self.prefill_prompt_tokens = 0
        self._queues: Dict[str, Deque[Request]] = {c: deque()
                                                   for c in SLO_CLASSES}
        self.completed: List[Request] = []
        self.expired: List[Request] = []
        self.admission_mode: MorphMode = self.ctrl.modes[-1]
        self.step_count = 0
        self.compiles_after_warmup: Optional[int] = None
        self.decode_launches = 0
        self.per_mode_launch_equiv = 0
        self.ticks_with_work = 0
        # per-slot width tensors memoized by widths tuple: widths only change
        # on admission, so a steady tick makes no host-to-device copy for them
        self._active_cache: Dict[Tuple[float, ...], Dict] = {}

    def _active_for(self, widths: List[float]) -> Dict:
        key = tuple(widths)
        active = self._active_cache.get(key)
        if active is None:
            if len(self._active_cache) > 1024:  # oscillation backstop
                self._active_cache.clear()
            active = elastic.active_widths_batch(self.cfg, widths,
                                                 device=self.device)
            self._active_cache[key] = active
        return active

    # -- observability ------------------------------------------------------

    @property
    def admission_switch_log(self):
        """(step, from, to, queued interactive, queued batch) tuples."""
        return _TupleView(self._ev_admission_switch,
                          fields=("step", "from_mode", "to_mode",
                                  "queued_interactive", "queued_batch"))

    @property
    def admission_decision_log(self):
        """SLO policy decision inputs per admission switch (dict rows)."""
        return self._ev_admission_decision

    def _metric_gauges(self) -> Dict[str, float]:
        out = {
            "engine_step_count": float(self.step_count),
            "engine_active_slots": float(self.n_active),
            "engine_queued_interactive":
                float(len(self._queues["interactive"])),
            "engine_queued_batch": float(len(self._queues["batch"])),
            "engine_completed": float(len(self.completed)),
            "engine_expired": float(len(self.expired)),
        }
        for name, t in self.ctrl.telemetry.items():
            if t.steps:
                out[f"mode_{name}_p50_ms"] = t.p50_s * 1e3
                out[f"mode_{name}_p95_ms"] = t.p95_s * 1e3
                out[f"mode_{name}_p99_ms"] = t.p99_s * 1e3
        return out

    def export_metrics(self, events: bool = False) -> Dict:
        return self.metrics.to_json(events=events)

    def export_trace(self) -> Dict:
        return self._rec.export_chrome_trace()

    # -- lifecycle ----------------------------------------------------------

    def warmup(self) -> None:
        """Build every depth's step and run it once, then rewind.

        After this, ``self.ctrl.stats['compiles']`` is frozen at
        ``len(depths)``: width and depth churn re-dispatches these steps."""
        self.ctrl.warmup()
        tok = self.executor.put(np.zeros((self.batch_size, 1), np.int64))
        active = self._active_for([1.0] * self.batch_size)
        mask = self.executor.put(np.ones((self.batch_size,), bool))
        for d, g in self.groups.items():
            step = self.ctrl.step_for(self._any_mode_at(d))
            _, cache = step(self.params, g.cache, tok, active)
            cache = self._reset(cache, mask)
            _block_until_ready(cache)
            g.cache = self.executor.init_cache()  # warmup wrote pos 0
        self.compiles_after_warmup = self.ctrl.stats["compiles"]

    def _any_mode_at(self, depth: int) -> MorphMode:
        return next(m for m in self.ctrl.modes if m.depth == depth)

    @property
    def queue(self) -> Tuple[Request, ...]:
        """Waiting requests in admission order (interactive before batch)."""
        return tuple(self._queues["interactive"]) + tuple(self._queues["batch"])

    def submit(self, req: Request) -> None:
        if not req.prompt:
            raise ValueError(f"request {req.rid} has an empty prompt")
        if req.slo_class not in SLO_CLASSES:
            raise ValueError(f"request {req.rid}: unknown slo_class "
                             f"{req.slo_class!r} (want one of {SLO_CLASSES})")
        # the last generated token is never fed back, so the highest cache
        # position written is prompt + new - 2
        need = len(req.prompt) + req.max_new_tokens - 1
        if need > self.cache_capacity:
            raise ValueError(f"request {req.rid} needs {need} cache slots, "
                             f"capacity is {self.cache_capacity}")
        self._queues[req.slo_class].append(req)
        if self._rec.enabled:
            self._rec.request_begin(req.rid, slo_class=req.slo_class,
                                    prompt_len=len(req.prompt),
                                    max_new_tokens=req.max_new_tokens)

    def _pop_next(self) -> Optional[Request]:
        for cls in SLO_CLASSES:
            if self._queues[cls]:
                return self._queues[cls].popleft()
        return None

    def set_admission_mode(self, mode: MorphMode) -> None:
        if mode.name != self.admission_mode.name:
            self._ev_admission_switch.emit(
                step=self.step_count, from_mode=self.admission_mode.name,
                to_mode=mode.name,
                queued_interactive=len(self._queues["interactive"]),
                queued_batch=len(self._queues["batch"]), frontier_gen=-1)
            self.ctrl.set_mode(mode)
        self.admission_mode = mode

    # -- one tick -----------------------------------------------------------

    def _use_prefill(self, req: Request) -> bool:
        return len(req.prompt) >= self.prefill_threshold

    def _expire_queued(self, now_s: float) -> None:
        """Retire queued requests past their deadline (terminal ``expired``)."""
        for cls in SLO_CLASSES:
            q = self._queues[cls]
            if not any(r.deadline_s is not None for r in q):
                continue
            kept: Deque[Request] = deque()
            for r in q:
                if r.deadline_s is not None and now_s > r.deadline_s:
                    r.status = "expired"
                    r.finished_s = now_s
                    self.expired.append(r)
                    if self._rec.enabled:
                        self._rec.request_end(r.rid, "expired",
                                              tokens=len(r.generated))
                else:
                    kept.append(r)
            self._queues[cls] = kept

    def _admit(self, now_s: float = 0.0) -> None:
        self._expire_queued(now_s)
        g = self.groups[self.admission_mode.depth]
        mask = np.zeros(self.batch_size, bool)
        prefills = []
        for slot in g.free_slots():
            req = self._pop_next()
            if req is None:
                break
            g.slots[slot] = req
            g.widths[slot] = self.admission_mode.width
            req.status = "active"
            req.mode_name = self.admission_mode.name
            req.admitted_step = self.step_count
            if self._rec.enabled:
                self._rec.request_event(req.rid, "admit",
                                        step=self.step_count, slot=slot,
                                        depth=g.depth,
                                        width=self.admission_mode.width)
            if self._use_prefill(req):
                prefills.append((slot, req))
            else:
                mask[slot] = True
        if mask.any():
            # ONE batched reset per tick, however large the admission burst
            g.cache = self._reset(g.cache, self.executor.put(mask))
        for slot, req in prefills:
            self._admit_prefill(g, slot, req, now_s)

    def _complete(self, g: _DepthGroup, slot: int, req: Request,
                  now_s: float) -> None:
        req.finished_s = now_s
        req.status = "done"
        self.completed.append(req)
        g.slots[slot] = None
        if self._rec.enabled:
            self._rec.request_end(req.rid, "done", tokens=len(req.generated))

    def _prefill_launch(self, g: _DepthGroup, slot: int,
                        prompt: Tuple[int, ...]):
        """Whole-prompt consume + slot adoption; returns last-position logits."""
        plen = len(prompt)
        key = (plen, g.depth)
        fn = self._prefills.get(key)
        if fn is None:
            if len(self._prefills) > 256:
                self._prefills.clear()
            fn = self.executor.prefill_fn(plen, g.depth)
            self._prefills[key] = fn
        toks = self.executor.put(np.asarray([prompt], np.int64))
        logits, pre = fn(self.params, toks, slot)
        g.cache = self._adopt(g.cache, pre, slot)
        return logits

    def _admit_prefill(self, g: _DepthGroup, slot: int, req: Request,
                       now_s: float) -> None:
        """Consume the whole prompt in one prefill + adoption."""
        self.executor.launch("prefill")
        t0 = self._clock()
        logits = self._prefill_launch(g, slot, req.prompt)
        req.prefilled = True
        # the prefill's last-position logits yield the first generated token
        nxt = int(torch.argmax(logits[0, 0, : self.cfg.vocab_size]).item())
        _block_until_ready(g.cache)
        t1 = self._clock()
        self.prefill_s += t1 - t0
        self.prefills += 1
        self.prefill_prompt_tokens += len(req.prompt)
        self._h_prefill.observe((t1 - t0) * 1e3)
        req.fed = len(req.prompt)
        req.generated.append(nxt)
        if self._rec.enabled:
            self._rec.launch("prefill", t0, t1, depth=g.depth,
                             rids=[req.rid], occupancy=1, tokens=1,
                             key=[len(req.prompt), g.depth])
            self._rec.request_event(req.rid, "prefill", t=t1,
                                    prompt_tokens=len(req.prompt))
            self._rec.request_event(req.rid, "first_token", t=t1)
        if req.done:
            self._complete(g, slot, req, now_s)

    def step(self, now_s: float = 0.0) -> float:
        """One engine tick. Returns device wall-time spent (seconds)."""
        self._admit(now_s)
        spent = 0.0
        ticked = False
        for g in self.groups.values():
            active_ix = [i for i, r in enumerate(g.slots) if r is not None]
            if not active_ix:
                continue
            ticked = True
            self.executor.launch("decode")
            toks = np.zeros((self.batch_size, 1), np.int64)
            for i in active_ix:
                toks[i, 0] = g.slots[i].next_input()
            active = self._active_for(g.widths)
            # telemetry attribution: the widest width in flight bounds this
            # launch's active compute
            w_max = max(g.widths[i] for i in active_ix)
            mode = self._mode_by_dw[(g.depth, w_max)]
            rec_on = self._rec.enabled
            rids = [g.slots[i].rid for i in active_ix] if rec_on else None
            t0 = self._clock() if rec_on else 0.0
            logits, g.cache = self.ctrl.timed_step(
                self.params, g.cache, self.executor.put(toks), active,
                mode=mode, tokens=len(active_ix))
            spent += self.ctrl.last_step_s
            self._h_decode.observe(self.ctrl.last_step_s * 1e3)
            self.decode_launches += 1
            self.per_mode_launch_equiv += len(
                {(g.depth, g.widths[i]) for i in active_ix})
            nxt = torch.argmax(logits[:, 0, : self.cfg.vocab_size],
                               dim=-1).cpu().numpy()
            produced = 0
            for i in active_ix:
                req = g.slots[i]
                req.fed += 1
                # once the prompt is consumed, each step's argmax is a fresh
                # generated token
                if req.fed >= len(req.prompt) and not req.done:
                    req.generated.append(int(nxt[i]))
                    produced += 1
                    if rec_on and len(req.generated) == 1:
                        self._rec.request_event(req.rid, "first_token")
                if req.done:
                    self._complete(g, i, req, now_s)
            if rec_on:
                self._rec.launch(
                    "decode", t0, t0 + self.ctrl.last_step_s, depth=g.depth,
                    rids=rids, occupancy=len(active_ix), tokens=produced,
                    widths=[g.widths[i] for i in active_ix],
                    key=["decode", g.depth])
        self.ticks_with_work += ticked
        self.step_count += 1
        return spent

    # -- driving loops ------------------------------------------------------

    @property
    def n_active(self) -> int:
        return sum(g.n_active for g in self.groups.values())

    def _generated_total(self) -> int:
        """Tokens generated so far by completed AND in-flight requests."""
        live = sum(len(r.generated) for g in self.groups.values()
                   for r in g.slots if r is not None)
        return sum(len(r.generated) for r in self.completed) + live

    def run(self, trace: Sequence[Request], *,
            budget_fn: Optional[Callable[[float], float]] = None,
            policy: Optional[SLOPolicy] = None,
            max_steps: int = 100_000) -> Dict[str, float]:
        """Drive an arrival trace to completion on a virtual clock that
        advances by measured step time. Returns a summary dict (counters are
        deltas over this run; ``compiles`` stays absolute)."""
        if (policy is None) != (budget_fn is None):
            raise ValueError("policy and budget_fn must be passed together "
                             "(one without the other silently disables the "
                             "SLO loop)")
        pending = deque(sorted(trace, key=lambda r: r.arrival_s))
        clock = 0.0
        busy = 0.0
        completed0 = len(self.completed)
        generated0 = self._generated_total()
        adm_switches0 = len(self.admission_switch_log)
        mode_switches0 = self.ctrl.stats["switches"]
        steps0 = self.step_count
        launches0 = self.decode_launches
        permode0 = self.per_mode_launch_equiv
        ticks0 = self.ticks_with_work
        prefills0 = self.prefills
        prefill_s0 = self.prefill_s
        prefill_toks0 = self.prefill_prompt_tokens
        expired0 = len(self.expired)
        while (pending or self.queue or self.n_active) \
                and self.step_count - steps0 < max_steps:
            while pending and pending[0].arrival_s <= clock:
                self.submit(pending.popleft())
            if not self.queue and not self.n_active:
                clock = pending[0].arrival_s  # idle: jump to next arrival
                continue
            if policy is not None and budget_fn is not None:
                qd = {c: len(q) for c, q in self._queues.items()}
                mode = policy.choose(budget_fn(clock), queue_depths=qd)
                if mode.name != self.admission_mode.name:
                    self.admission_decision_log.append(
                        dict(step=self.step_count, **policy.last_decision))
                self.set_admission_mode(mode)
            dt = self.step(now_s=clock)
            busy += dt
            clock += dt
        total_generated = self._generated_total() - generated0
        launches = self.decode_launches - launches0
        ticks = self.ticks_with_work - ticks0
        prefill_s = self.prefill_s - prefill_s0
        prefill_toks = self.prefill_prompt_tokens - prefill_toks0
        return {
            "completed": len(self.completed) - completed0,
            "generated_tokens": total_generated,
            "busy_s": busy,
            "clock_s": clock,
            "sustained_tokens_per_s": total_generated / busy if busy > 0 else 0.0,
            "admission_switches": len(self.admission_switch_log) - adm_switches0,
            "mode_switches": self.ctrl.stats["switches"] - mode_switches0,
            "compiles": self.ctrl.stats["compiles"],
            "decode_launches": launches,
            "per_mode_launch_equiv": self.per_mode_launch_equiv - permode0,
            "launches_per_tick": launches / ticks if ticks else 0.0,
            "prefills": self.prefills - prefills0,
            "prefill_prompt_tokens": prefill_toks,
            "prompt_consume_ms_per_token":
                prefill_s / prefill_toks * 1e3 if prefill_toks else 0.0,
            "expired": len(self.expired) - expired0,
        }


def _counter_property(metric: str) -> property:
    def _get(self):
        return self._counter_objs[metric].value

    def _set(self, v):
        self._counter_objs[metric].set(v)

    return property(_get, _set)


for _attr, _metric in ServingEngine._COUNTER_METRICS.items():
    setattr(ServingEngine, _attr, _counter_property(_metric))
del _attr, _metric
