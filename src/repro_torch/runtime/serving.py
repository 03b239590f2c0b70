"""Continuous-batching NeuroMorph serving engine.

Port of ``repro.runtime.serving`` for the slices the port covers: a dense
per-slot KV cache or SSM recurrent state, one-token decode (greedy or
sampled), linear self-speculative decoding, prefill admission, per-depth
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

* **Self-speculative decoding, linear and token-tree drafts.** With
  ``speculative=SpecConfig(...)`` each depth group that has a shallower
  exit drafts at that exit and verifies in one full-depth pass per tick
  (``runtime.speculative``): a linear draft chains K tokens and verifies
  K+1 positions; a token tree (``SpecConfig.trees``, a static branching
  schedule) is drafted level by level with K/V carried forward, verified
  in one ``verify_tree`` pass (ancestor-mask attention, per-node SSM
  state) and its accepted root-to-leaf path committed through a path-index
  gather. The commit happens on the device and the host reads
  ``(out_tokens, n_accepted)`` once per tick. Acceptance telemetry feeds
  the SLO policy's draft-shape choice (``choose_tree``: a tree, a linear K
  or plain stepping; ``choose_spec_k`` without trees); an acceptance
  collapse falls back to plain stepping for a cooloff
  (``spec_fallback_log``).
* **Sampling.** ``temperature > 0`` (and ``top_k``) sample from per-slot
  keys folded with the tick count (``runtime.sampling``).

* **Block-paged KV cache.** With ``paged=PagedLayout(...)`` each depth
  group keeps one physical page pool instead of per-slot buffers
  (``models.paged``) and a host-side ``_GroupPaging``: a ``BlockAllocator``
  over the pool, the ``(n_slots, cap_pages)`` page table, a scratch page
  per slot that free slots' rows point at, worst-case page reservations at
  admission, copy-on-write before any write into a shared page, and a
  ``RadixCache`` through which prompts that share full-page prefixes map
  the same physical pages. Plain ticks run the ``("paged_decode", depth,
  bucket)`` step of the smallest table-width bucket covering every active
  slot; speculative ticks read the pool through the full-width table and
  trim the pages of rejected drafts. Paged serving gives the dense
  engine's tokens.

``fused=True`` routes every attention layer through the fused decode and
verify kernels (a closure flag on the step callables; SSM layers have no
fused path and ignore it; a tree draft's level passes take the einsum
path, as the reference's do). Every tick and the warmup run under
``torch.no_grad()``, so parameters that require grad (fresh from
training) serve as they are.

* **Snapshot / restore.** ``snapshot`` cuts the host-side truth (requests,
  counters, logs, telemetry, metrics; nothing on the device) and
  ``restore`` rebuilds a geometry-compatible engine from it, re-making
  every cache by replaying each live slot's committed tokens through the
  same steps: its prompt through the prefill it was admitted with, the
  rest in lockstep launches that end together, up to ``c_max = 8`` tokens
  a launch through one force-committed verify (``replay_chunk_fn``).
  ``runtime.fault_tolerance.ExecutorSupervisor`` cuts one before every
  tick and fails over onto a standby engine. The snapshot carries a bound
  autoscaler's state (``runtime.autoscale``); a standby with none holds it
  in ``_pending_autoscale`` until one binds.
"""
from __future__ import annotations

import copy
import statistics
from collections import deque
from dataclasses import dataclass, field, replace
from typing import Callable, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, MorphMode, ShapeCell
from repro_torch.core import elastic
from repro_torch.core.morph import (MorphController, _block_until_ready,
                                    make_serve_controller,
                                    paged_decode_compile_key,
                                    policy_for_budget)
from repro_torch.core.neuroforge.analytical import estimate_mode
from repro_torch.core.neuroforge.hw import DEFAULT_HW, HardwareSpec
from repro_torch.core.neuroforge.space import DesignPoint
from repro_torch.device import resolve_device
from repro_torch.models.model import (adopt_cache_slot, commit_verify,
                                      init_decode_cache, prefill,
                                      reset_cache_slots, verify_step)
from repro_torch.models.paged import (PagedLayout, adopt_paged_slot,
                                      copy_page, init_paged_cache)
from repro_torch.runtime import sampling
from repro_torch.runtime.observability import (MetricsRegistry,
                                               Observability, _TupleView)
from repro_torch.runtime.paged_cache import BlockAllocator, RadixCache
from repro_torch.runtime.speculative import (SpecConfig, SpecTelemetry,
                                             draft_compile_key,
                                             expected_tokens_per_launch,
                                             expected_tokens_per_tree_launch,
                                             per_candidate_accept_rate,
                                             tree_draft_compile_key,
                                             tree_node_budget,
                                             tree_verify_compile_key,
                                             verify_compile_key)

SLO_CLASSES = ("interactive", "batch")


def _shape_label(shape) -> str:
    """Draft-shape label: ``k3`` linear lengths, ``t3x2x1`` tree schedules."""
    if isinstance(shape, tuple):
        return "t" + "x".join(str(b) for b in shape)
    return f"k{shape}"


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


def _same(value):
    return value


class SLOPolicy:
    """Pick the widest mode whose predicted step latency fits the budget.

    Prediction = analytical roofline estimate (``neuroforge.analytical`` on
    ``hw``, the H100 data sheet by default) scaled by an online correction
    learned from the controller's per-mode telemetry. Once a mode has
    ``min_samples`` measured steps its own p50 is used directly, and the
    measured/analytical ratio of observed modes corrects the rest.

    ``executor`` (the engine's) sets the design point's ``dp`` / ``tp`` and,
    over a mesh, makes every choice rank 0's (``LocalExecutor.agree``): the
    measured latencies differ from rank to rank.
    """

    def __init__(self, cfg: ModelConfig, controller: MorphController, *,
                 batch_size: int, cache_capacity: int,
                 hw: HardwareSpec = DEFAULT_HW, min_samples: int = 3,
                 queue_gamma: float = 0.25,
                 interactive_weight: float = 2.0,
                 metrics: Optional[MetricsRegistry] = None,
                 catchup_ticks: int = 8, catchup_gamma: float = 1.0,
                 executor: Optional["LocalExecutor"] = None):
        self.cfg = cfg
        self.controller = controller
        # every choice reads measured latencies, a clock: on a mesh all
        # ranks take rank 0's (``LocalExecutor.agree``)
        self._agree = executor.agree if executor is not None else _same
        self.min_samples = min_samples
        self.batch_size = batch_size
        # budget-aware admission: how strongly queue depth squeezes the
        # effective latency budget (0 disables), and how much heavier a
        # queued interactive request weighs than a batch one
        self.queue_gamma = queue_gamma
        self.interactive_weight = interactive_weight
        # post-failover catch-up: for ``catchup_ticks`` choose() calls after
        # a failover the effective budget is squeezed by the measured
        # recovery latency (``failover_recovery_ms`` p50 on ``metrics``
        # unless the supervisor passes it), downshifting while the engine
        # re-earns the latency the recovery cost its requests
        self.metrics = metrics
        self.catchup_ticks = catchup_ticks
        self.catchup_gamma = catchup_gamma
        self._catchup_left = 0
        self._last_recovery_ms = 0.0
        self.last_decision: Dict[str, float] = {}
        cell = ShapeCell("serve_step", seq_len=cache_capacity,
                         global_batch=batch_size, kind="decode")
        pt = DesignPoint(dp=executor.dp if executor is not None else 1,
                         tp=executor.tp if executor is not None else 1,
                         microbatches=1, remat="none",
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
        effective budget is ``budget / (1 + queue_gamma * pressure)``.

        During post-failover catch-up (``note_failover``) the budget is
        squeezed further: recovery stole ``recovery_ms`` of serving time,
        so each of the next ``catchup_ticks`` decisions acts as if it owed
        back its share, ``eff /= 1 + min(catchup_gamma * debt / budget,
        4)``. The penalty lands in ``last_decision`` and, with a registry
        attached, in the ``slo_catchup`` event stream."""
        pressure = self._queue_pressure(queue_depths)
        eff = budget_s / (1.0 + self.queue_gamma * pressure)
        catchup_penalty = 0.0
        if self._catchup_left > 0 and budget_s > 0:
            debt_s = self._last_recovery_ms / 1e3 / max(self.catchup_ticks, 1)
            catchup_penalty = min(self.catchup_gamma * debt_s / budget_s, 4.0)
            eff /= (1.0 + catchup_penalty)
            self._catchup_left -= 1
        mode = self._agree(policy_for_budget(self.cfg, self.controller, eff,
                                             self.est_latency))
        self.last_decision = {
            "budget_s": budget_s, "effective_budget_s": eff,
            "queue_pressure": pressure, "mode": mode.name,
            "catchup_penalty": catchup_penalty,
            "queued_interactive": (queue_depths or {}).get("interactive", 0),
            "queued_batch": (queue_depths or {}).get("batch", 0),
        }
        if catchup_penalty > 0 and self.metrics is not None:
            self.metrics.events(
                "slo_catchup",
                ("budget_s", "effective_budget_s", "catchup_penalty",
                 "recovery_ms", "ticks_left", "mode"),
            ).emit(budget_s=budget_s, effective_budget_s=eff,
                   catchup_penalty=catchup_penalty,
                   recovery_ms=self._last_recovery_ms,
                   ticks_left=self._catchup_left, mode=mode.name)
        return mode

    def note_failover(self, recovery_ms: Optional[float] = None) -> None:
        """Start a catch-up window after an executor failover.
        ``recovery_ms`` defaults to the ``failover_recovery_ms`` histogram's
        p50 on the attached registry: the typical measured cost, not only
        the last."""
        if recovery_ms is None and self.metrics is not None:
            h = self.metrics.histograms.get("failover_recovery_ms")
            if h is not None and h.count:
                recovery_ms = h.p50
        self._last_recovery_ms = float(recovery_ms or 0.0)
        self._catchup_left = (self.catchup_ticks
                              if self._last_recovery_ms > 0 else 0)

    def choose_spec_k(self, ks: Sequence[int], accept_rate: float,
                      queue_depths: Optional[Dict[str, int]] = None) -> int:
        """Pick the draft length K from the built table: rank each K by
        expected tokens per verify launch at the measured acceptance rate,
        keeping a longer K only while its marginal gain beats the
        queue-pressure-scaled cost of drafting (a deep queue biases toward
        smaller K)."""
        ks = sorted(set(ks))
        pressure = self._queue_pressure(queue_depths)
        cut = self.queue_gamma * pressure / (1.0 + self.queue_gamma * pressure)
        best = ks[0]
        for k in ks:
            gain = expected_tokens_per_launch(accept_rate, k)
            prev = expected_tokens_per_launch(accept_rate, best)
            if gain - prev > cut * (k - best) / max(max(ks), 1):
                best = k
        return self._agree(best)

    def choose_tree(self, trees: Sequence[Tuple[int, ...]],
                    ks: Sequence[int], accept_rate: float,
                    queue_depths: Optional[Dict[str, int]] = None,
                    min_accept_rate: float = 0.05) -> Tuple[str, object]:
        """Pick the draft shape for the next speculative ticks: a token tree
        from the built ``trees`` table, a linear K from ``ks``, or plain
        stepping. Each candidate is ranked by expected tokens per verify
        launch at the measured acceptance rate
        (``expected_tokens_per_tree_launch``: a level of b siblings survives
        with prob 1 - (1-a)^b) minus a queue-pressure-scaled node cost, so
        a backlog shrinks the tree as it shrinks K. Below
        ``min_accept_rate`` every draft is expected waste: ``("plain",
        None)``. Returns ``("tree", branching)``, ``("linear", k)`` or
        ``("plain", None)``."""
        if accept_rate < min_accept_rate:
            return self._agree(("plain", None))
        cands = ([("linear", k, k) for k in sorted(set(ks))]
                 + [("tree", tuple(br), tree_node_budget(br))
                    for br in trees])
        if not cands:
            return self._agree(("plain", None))
        pressure = self._queue_pressure(queue_depths)
        cut = self.queue_gamma * pressure / (1.0 + self.queue_gamma * pressure)
        max_nodes = max(nodes for _, _, nodes in cands)

        def value(kind, shape, nodes):
            e = (expected_tokens_per_launch(accept_rate, shape)
                 if kind == "linear"
                 else expected_tokens_per_tree_launch(accept_rate, shape))
            return e - cut * nodes / max(max_nodes, 1)

        best = max(cands, key=lambda c: value(*c))
        return self._agree((best[0], best[1]))


# ---------------------------------------------------------------------------
# executor seam — where device placement and step building live
# ---------------------------------------------------------------------------


class LocalExecutor:
    """Single-device execution backend (the card unless told otherwise).

    The engine delegates every device decision to its executor: parameter
    placement, per-depth controller building, cache allocation, and the
    cache-side ops (batched slot reset, prefill, prefill adoption).
    ``launch_hook`` is the one seam every launch boundary announces itself
    through ("decode", "verify", "prefill"), shared by tracing and failure
    injection.
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

    def agree(self, value):
        """A host decision every rank must share, taken from a clock (a
        deadline, a measured latency): the identity on one device; a mesh
        executor takes rank 0's value."""
        return value

    def bind(self, cfg: ModelConfig, batch_size: int, cache_capacity: int,
             paged: Optional[PagedLayout] = None,
             fused: bool = False) -> "LocalExecutor":
        self._cfg = cfg
        # the config the steps run on: a mesh rank's is its shard's
        self._step_cfg = cfg
        self._batch = batch_size
        self._cap = cache_capacity
        self._paged = paged
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

    def _paged_kwargs(self, cfg: ModelConfig) -> Dict:
        if self._paged is None:
            return {}
        return dict(paged_page_size=self._paged.page_size,
                    paged_buckets=self._paged.buckets(cfg, self._cap))

    def make_controller(self, params, cfg: ModelConfig, modes,
                        speculative=None) -> MorphController:
        return make_serve_controller(params, cfg, modes,
                                     speculative=speculative,
                                     fused=self._fused,
                                     **self._paged_kwargs(cfg))

    def init_cache(self):
        if self._paged is not None:
            return init_paged_cache(self._cfg, self._batch, self._cap,
                                    self._paged, device=self.device)
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

    def prefill_adopt_fn(self, prompt_len: int, depth: int, ncp: int):
        """Whole-prompt consume + paged adoption: (params, (1, L) tokens,
        slot, cache, (ncp,) physical pages, (ncp,) write mask) -> (last-token
        logits, cache with the prompt written into the pool in place). The
        prefill runs over ``ncp * page_size`` positions; pages masked False
        are resident through the shared-prefix radix and not rewritten."""
        cfg, n_slots = self._step_cfg, self._batch
        ps = self._paged.page_size

        def pf(params, tokens, slot, cache, pages, wmask):
            logits, pre = prefill(params, {"tokens": tokens}, cfg,
                                  cache_extra=max(ncp * ps - prompt_len, 0),
                                  per_slot=True, slot=slot, n_slots=n_slots,
                                  depth=depth)
            return logits, adopt_paged_slot(cache, pre, slot, pages, wmask,
                                            ps)

        return pf

    def copy_page_fn(self):
        """The copy-on-write page copy, in place on the cache."""
        return copy_page

    def replay_chunk_fn(self, depth: int, n_tokens: int):
        """Multi-token replay: (params, cache, (B, C) committed tokens,
        active[, (B, cap_pages) page table]) -> cache advanced by C
        positions on every slot, in place. One ``verify_step`` scores all C
        positions and ``commit_verify`` force-accepts them (``n_accepted =
        C - 1``): by the verify path's exactness the cache lands as C
        one-token decode steps would leave it, in one pass. ``fused``
        routes the pass through the fused verify kernel; a paged engine
        reads and writes the pool through the full-width table, planned
        like its speculative steps."""
        cfg, fused, paged = self._step_cfg, self._fused, self._paged
        ps = paged.page_size if paged is not None else 0
        plan_len = (max(paged.buckets(cfg, self._cap)) * ps
                    if paged is not None else 0)

        def chunk(params, cache, tokens, active, pages=None):
            _, pending = verify_step(params, cache, tokens, cfg, depth=depth,
                                     active=active, pages=pages,
                                     page_size=ps, plan_len=plan_len,
                                     fused=fused)
            n_acc = torch.full((tokens.shape[0],), n_tokens - 1,
                               dtype=torch.int64, device=tokens.device)
            return commit_verify(cache, pending, n_acc, cfg, pages=pages,
                                 page_size=ps)

        return chunk


class MeshExecutor(LocalExecutor):
    """SPMD execution over a (data, model) ``DeviceMesh``: one rank's shard.

    Every rank runs the same engine on the same requests. The rank holds
    its shard of every parameter (``sharding.shard_serve_params``) and of
    every cache (the shard-local config's cache over its slots), and its
    steps (``make_serve_controller(mesh=...)``) launch only its shard's
    kernels, with the collectives of ``parallel.tensor_parallel`` where the
    JAX partitioner places them; the logits every step returns are
    replicated, so host decisions taken from them agree on every rank.
    Decisions taken from a clock go through ``agree`` (rank 0's value,
    broadcast).

    ``policy`` defaults to ``sharding.serve_policy(cfg, tp)``. Under
    ``serve_tp`` a rank holds its ``serve_tp`` shard; under ``serve_2d`` it
    holds ``param_specs(..., "serve_2d")``'s cut (split over ``data`` too)
    and each step gathers a layer group's data-split dims over ``data``
    just before the group runs (``tensor_parallel.Serve2D``), so both run
    the same kernels at the same shapes. Every family serves: MoE experts
    split as ``param_specs`` splits them, the encoder-decoder and frontend
    families with their encoder, cross-attention and frontend projection
    (their token prompts fed step by step, as on one device). Slots split
    over ``data`` where
    ``n_slots % dp == 0`` and the cache is dense (``plan_serve_shard``);
    the batch-1 prompt pass runs on every rank, as the reference's
    replicated prefill does, and only the slot's owner keeps its rows.
    ``device`` defaults to the card this process has selected.
    """

    def __init__(self, mesh, policy: Optional[str] = None, device=None):
        from repro_torch.parallel import sharding as SH

        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        self.mesh = mesh
        self._policy_arg = policy
        sizes = SH.axis_sizes(mesh)
        self.tp = sizes.get("model", 1)
        self.dp = 1
        for a in SH.data_axes(mesh):
            self.dp *= sizes[a]

    def bind(self, cfg: ModelConfig, batch_size: int, cache_capacity: int,
             paged: Optional[PagedLayout] = None,
             fused: bool = False) -> "MeshExecutor":
        import torch.distributed as dist

        from repro_torch.parallel import sharding as SH
        from repro_torch.parallel.tensor_parallel import ShardComm

        super().bind(cfg, batch_size, cache_capacity, paged=paged,
                     fused=fused)
        self.policy = self._policy_arg or SH.serve_policy(cfg, self.tp)
        if self.policy not in ("serve_tp", "serve_2d"):
            raise ValueError(f"serving policy {self.policy!r}; expected "
                             f"serve_tp or serve_2d")
        shard = SH.plan_serve_shard(cfg, self.mesh, n_slots=batch_size,
                                    paged=paged is not None)
        groups = self.mesh.mesh_dim_names
        self.comm = ShardComm(
            shard,
            model_group=(self.mesh.get_group("model")
                         if "model" in groups else None),
            data_group=(self.mesh.get_group("data")
                        if "data" in groups else None),
            stage=dist.get_backend() == "gloo" and self.device.type == "cuda")
        self.world = dist.get_world_size()
        self.shard = shard
        self._step_cfg = shard.cfg
        return self

    def agree(self, value):
        if self.world == 1:
            return value
        import torch.distributed as dist

        box = [value]
        dist.broadcast_object_list(box, src=0)
        return box[0]

    def place_params(self, params):
        from repro_torch.parallel import sharding as SH
        from repro_torch.parallel.tensor_parallel import Serve2D

        if self.policy == "serve_2d":
            specs, recipes = SH.serve_2d_plan(params, self.shard, self._cfg,
                                              self.mesh)
            self.comm.serve2d = Serve2D(recipes, self.comm.data_group,
                                        self.dp, self.comm.stage)
            return super().place_params(
                SH.shard_params(params, specs, self.mesh))
        return super().place_params(
            SH.shard_serve_params(params, self.shard, self._cfg))

    def make_controller(self, params, cfg: ModelConfig, modes,
                        speculative=None) -> MorphController:
        return make_serve_controller(params, cfg, modes, mesh=self.mesh,
                                     shard=self.comm, speculative=speculative,
                                     fused=self._fused,
                                     **self._paged_kwargs(cfg))

    def _wrap(self, fn, n_lead: int = 2, slots: bool = True):
        from repro_torch.parallel.tensor_parallel import MeshStep

        return MeshStep(fn, self.comm, n_lead, slots=slots)

    def init_cache(self):
        lcfg = self.shard.cfg
        if self._paged is not None:
            return init_paged_cache(lcfg, self._batch, self._cap,
                                    self._paged, device=self.device)
        return init_decode_cache(lcfg, self.shard.slots[1], self._cap,
                                 per_slot=True, device=self.device)

    def reset_fn(self):
        sl = self.shard.slots

        def reset(cache, mask):
            return reset_cache_slots(cache, mask[sl[0]:sl[0] + sl[1]])

        return reset

    def adopt_fn(self):
        """Adopt a prompt pass's one-lane cache (``prefill_fn``) into the
        slot's lane, on the slot's owner only."""
        s0, n = self.shard.slots

        def adopt(cache, pre, slot):
            if s0 <= slot < s0 + n:
                for pn, layer in cache["stack"].items():
                    for k, full in layer.items():
                        full[:, slot - s0] = pre["stack"][pn][k][:, 0].to(
                            full.dtype)
                cache["pos"][slot - s0] = pre["pos"][0]
            return cache

        return adopt

    def prefill_fn(self, prompt_len: int, depth: int):
        """The batch-1 prompt pass on every rank, its cache one lane wide
        (``adopt_fn`` keeps it on the slot's owner)."""
        lcfg, cap = self.shard.cfg, self._cap

        def pf(params, tokens, slot):
            return prefill(params, {"tokens": tokens}, lcfg,
                           cache_extra=cap - prompt_len, per_slot=True,
                           slot=0, n_slots=1, depth=depth)

        return self._wrap(pf, n_lead=1, slots=False)

    def prefill_adopt_fn(self, prompt_len: int, depth: int, ncp: int):
        # paged: slots stay replicated over data, every rank adopts
        return self._wrap(super().prefill_adopt_fn(prompt_len, depth, ncp),
                          n_lead=1, slots=False)

    def replay_chunk_fn(self, depth: int, n_tokens: int):
        return self._wrap(super().replay_chunk_fn(depth, n_tokens))


class _GroupPaging:
    """Host-side page bookkeeping for ONE depth group's paged cache.

    Port of the JAX engine's ``_GroupPaging``. Owns the group's
    ``BlockAllocator`` (free list + refcounts over the physical pool), the
    ``(n_slots, cap_pages)`` page table shipped to every launch, a host
    mirror of the device position counter (``host_pos``, advanced exactly
    as the steps advance ``cache['pos']``), and, for full attention only,
    the shared-prefix ``RadixCache`` plus one permanently owned scratch page
    per slot that free slots' table rows point at (whole-batch launches
    write their garbage somewhere harmless).

    Sliding-window groups are ``fixed``: the rolling buffer is always
    ``window // page_size`` pages, so every slot permanently owns its pages
    (no allocator churn, no prefix sharing, no scratch).
    """

    def __init__(self, layout: PagedLayout, cfg: ModelConfig, n_slots: int,
                 capacity: int):
        self.layout = layout
        self.ps = layout.page_size
        self.cap_pages = layout.cap_pages(cfg, capacity)
        self.fixed = bool(cfg.sliding_window)
        self.n_slots = n_slots
        self.alloc = BlockAllocator(layout.pool_pages(cfg, n_slots, capacity))
        self.table = np.zeros((n_slots, self.cap_pages), np.int32)
        self.host_pos = np.zeros((n_slots,), np.int64)
        self.pages: List[List[int]] = [[] for _ in range(n_slots)]
        self.scratch: List[int] = []
        self.radix: Optional[RadixCache] = None
        # admission control: worst-case page reservation per slot, booked
        # when a request is admitted and released with the slot; admissions
        # that would overbook the pool are deferred (backpressure) instead
        # of hitting the mid-flight exhaustion hard error
        self.budget: List[int] = [0] * n_slots
        self.budgeted = 0
        if self.fixed:
            for i in range(n_slots):
                self.pages[i] = [self.alloc.alloc()
                                 for _ in range(self.cap_pages)]
                self.table[i, :] = self.pages[i]
        else:
            self.radix = RadixCache(self.alloc)
            for i in range(n_slots):
                s = self.alloc.alloc()
                self.scratch.append(s)
                self.table[i, :] = s

    def _alloc_page(self) -> int:
        """Allocate one page, evicting LRU radix prefixes while the pool is
        dry. Evicting a node frees its page only when no live slot still
        maps it, so the loop evicts until a page frees or the tree is empty;
        then exhaustion is a hard error (live slots alone exceed the pool)."""
        while not self.alloc.can_alloc():
            if self.radix is None or not self.radix.evict_lru(1):
                raise RuntimeError(
                    "kv page pool exhausted: live slots reference every "
                    "page (raise --kv-pages or lower concurrency)")
        return self.alloc.alloc()

    def ensure_slot(self, i: int, last_pos: int) -> None:
        """Grow slot ``i``'s mapping to cover a write at ``last_pos``."""
        if self.fixed:
            return
        need = min(last_pos // self.ps + 1, self.cap_pages)
        while len(self.pages[i]) < need:
            p = self._alloc_page()
            self.table[i, len(self.pages[i])] = p
            self.pages[i].append(p)

    @property
    def reservable(self) -> int:
        """Pages admissions may budget against: the pool minus scratch
        (radix-held pages are slack: eviction reclaims them on demand)."""
        return self.alloc.n_pages - len(self.scratch)

    def can_reserve(self, need: int) -> bool:
        return self.fixed or self.budgeted + need <= self.reservable

    def reserve(self, i: int, need: int) -> None:
        """Book slot ``i``'s worst-case page demand against the pool."""
        if self.fixed:
            return  # fixed groups permanently own their pages
        self.budgeted += need - self.budget[i]
        self.budget[i] = need

    def release(self, i: int) -> None:
        """Drop slot ``i``'s references; its table row falls back to scratch."""
        self.host_pos[i] = 0
        self.budgeted -= self.budget[i]
        self.budget[i] = 0
        if self.fixed:
            return
        for p in self.pages[i]:
            self.alloc.decref(p)
        self.pages[i] = []
        self.table[i, :] = self.scratch[i]

    def trim(self, i: int) -> None:
        """Free tail pages past the committed position (speculative
        rollback: pages grown for rejected drafts go back to the pool)."""
        if self.fixed:
            return
        keep = min(int(self.host_pos[i]) // self.ps + 1, self.cap_pages)
        while len(self.pages[i]) > keep:
            p = self.pages[i].pop()
            self.alloc.decref(p)
            self.table[i, len(self.pages[i])] = self.scratch[i]

    def cow_pairs(self, i: int, first_pos: int,
                  last_pos: int) -> List[Tuple[int, int]]:
        """Copy-on-write: privatize shared pages in slot ``i``'s write range.

        Returns (src, dst) physical pairs for the engine to copy on the
        device before launching. Shared pages come only from full-page
        prompt prefixes and writes start at or past the prompt length, so
        this normally returns []: it guarantees that a slot never writes a
        page another slot or the radix tree can see."""
        if self.fixed:
            return []
        out: List[Tuple[int, int]] = []
        first = first_pos // self.ps
        last = min(last_pos // self.ps, self.cap_pages - 1)
        for j in range(first, min(last + 1, len(self.pages[i]))):
            p = self.pages[i][j]
            if self.alloc.refcount[p] > 1:
                q = self._alloc_page()
                self.pages[i][j] = q
                self.table[i, j] = q
                self.alloc.decref(p)
                out.append((p, q))
        return out

    # -- accounting (engine invariants / telemetry) -------------------------

    def check_invariants(self) -> None:
        """Exact page accounting: slot refs + scratch + radix == refcounts,
        free-list size matches zero-refcount pages, and every table row maps
        only pages its slot owns (or its scratch). AssertionError on drift."""
        refs = [0] * self.alloc.n_pages
        for i in range(self.n_slots):
            for p in self.pages[i]:
                refs[p] += 1
        for s in self.scratch:
            refs[s] += 1
        if self.radix is not None:
            for p in self.radix.held_pages():
                refs[p] += 1
        assert refs == self.alloc.refcount, (
            f"page refcount drift: expected {refs}, "
            f"allocator has {self.alloc.refcount}")
        n_zero = sum(1 for r in self.alloc.refcount if r == 0)
        assert n_zero == self.alloc.n_free, (
            f"free-list drift: {self.alloc.n_free} free vs "
            f"{n_zero} zero-refcount pages")
        for i in range(self.n_slots):
            own = self.pages[i]
            row = self.table[i]
            assert list(row[: len(own)]) == own, \
                f"slot {i}: table row disagrees with owned pages"
            if not self.fixed:
                tail = {int(x) for x in row[len(own):]}
                assert tail <= {self.scratch[i]}, \
                    f"slot {i}: tail maps non-scratch pages {tail}"
        assert self.budgeted == sum(self.budget), (
            f"admission budget drift: {self.budgeted} booked vs "
            f"per-slot sum {sum(self.budget)}")
        if not self.fixed:
            assert self.budgeted <= self.reservable, (
                f"admission overbooked: {self.budgeted} > "
                f"{self.reservable} reservable pages")
            for i in range(self.n_slots):
                assert self.budget[i] == 0 \
                    or len(self.pages[i]) <= self.budget[i], \
                    f"slot {i} maps {len(self.pages[i])} pages over its " \
                    f"admission budget {self.budget[i]}"

    def stats(self) -> Dict[str, float]:
        out = dict(self.alloc.metric_values())
        out["budgeted"] = self.budgeted
        out["reservable"] = self.reservable
        if self.radix is not None:
            out.update({f"radix_{k}": v
                        for k, v in self.radix.metric_values().items()})
        return out


@dataclass
class _DepthGroup:
    """One depth's slots: its full-width cache and the width fraction each
    occupant was admitted at."""

    depth: int
    cache: Dict
    slots: List[Optional[Request]]
    widths: List[float]  # admission width per slot (stale for free slots)
    keys: Optional[torch.Tensor] = None  # (B,) per-slot sample keys
    # speculative state (spec_k 0 and spec_tree None: this depth has no
    # shallower exit, or speculation is off engine-wide); the active token
    # tree takes precedence over spec_k (the SLO policy switches them)
    spec_k: int = 0
    spec_tree: Optional[Tuple[int, ...]] = None
    spec_off_until: int = -1  # tick until which speculation cools off
    accept_window: Optional[Deque[float]] = None
    paging: Optional[_GroupPaging] = None  # block-paged cache bookkeeping

    @property
    def n_active(self) -> int:
        return sum(r is not None for r in self.slots)

    def free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.slots) if r is None]


@dataclass
class GroupSnapshot:
    """Host-side truth of one depth group (see ``EngineSnapshot``)."""

    depth: int
    slots: List[Optional[Request]]  # deep copies: the snapshot owns them
    widths: List[float]
    spec_k: int
    spec_tree: Optional[Tuple[int, ...]]
    spec_off_until: int
    accept_window: List[float]
    accept_window_maxlen: Optional[int]


@dataclass
class EngineSnapshot:
    """Everything ``ServingEngine.restore`` needs to rebuild serving state
    on a fresh executor, and nothing on the device.

    Caches are not captured: every committed token is known on the host
    (``(prompt + generated)[:fed]`` per slot, cache position == ``fed``),
    so restore re-makes each live slot by replaying its committed stream
    through the steps that produced it. Speculative work in flight when the
    snapshot was cut is not state either: the next tick drafts and verifies
    it again. ``paging_stats`` is informational (occupancy before the
    failure); the page tables are rebuilt by the replay."""

    step_count: int
    admission_mode: str
    queues: Dict[str, List[Request]]
    completed: List[Request]
    expired: List[Request]
    groups: Dict[int, GroupSnapshot]
    counters: Dict[str, float]
    logs: Dict[str, list]
    telemetry: Dict[str, Dict]
    spec_telemetry: Dict
    paging_stats: Dict[int, Dict[str, float]]
    metrics: Optional[Dict] = None  # Observability.state_dict() of the source
    # Autoscaler.state_dict() of the source (None when none was bound)
    autoscale: Optional[Dict] = None


class ServingEngine:
    """Continuous-batching decode engine over a per-depth MorphController.

    One tick = admit queued requests into the admission mode's depth group
    (interactive first; long prompts via one prefill, short ones via one
    batched slot reset), then per depth group with active slots either ONE
    decode step or, when it speculates, one K-token draft plus one verify
    pass — slots of different widths ride the same step via per-slot width
    tensors. The host reads back one token per slot per decode tick, or
    ``(out_tokens, n_accepted)`` in one transfer per speculative tick.
    """

    _COUNTER_METRICS = {
        "prefills": "engine_prefills",
        "prefill_s": "engine_prefill_s",
        "prefill_prompt_tokens": "engine_prefill_prompt_tokens",
        "decode_launches": "engine_decode_launches",
        "per_mode_launch_equiv": "engine_per_mode_launch_equiv",
        "ticks_with_work": "engine_ticks_with_work",
        "spec_draft_launches": "engine_spec_draft_launches",
        "spec_verify_launches": "engine_spec_verify_launches",
        "spec_tree_launches": "engine_spec_tree_launches",
        "spec_generated_tokens": "engine_spec_generated_tokens",
        "backpressure_events": "engine_backpressure_events",
    }

    def __init__(self, params, cfg: ModelConfig, *, batch_size: int = 4,
                 cache_capacity: int = 64,
                 modes: Optional[Tuple[MorphMode, ...]] = None,
                 controller: Optional[MorphController] = None,
                 executor: Optional[LocalExecutor] = None,
                 prefill_threshold: int = 8,
                 speculative: Optional[SpecConfig] = None,
                 temperature: float = 0.0, top_k: int = 0,
                 sample_seed: int = 0,
                 paged=None,
                 fused: bool = False,
                 observability: Optional[Observability] = None,
                 device=None):
        if speculative is not None and cfg.sliding_window:
            # bound every draft shape's depth at the rolling window: the
            # verify commit's rolling scatter would alias buffer slots
            k_max = max(speculative.ks, default=0)
            if k_max + 1 > cfg.sliding_window:
                raise ValueError(
                    f"speculative K={k_max} needs K+1 <= sliding_window "
                    f"({cfg.sliding_window}): the verify commit's rolling "
                    f"scatter would alias buffer slots")
            for br in speculative.trees:
                if len(br) + 1 > cfg.sliding_window:
                    raise ValueError(
                        f"speculative tree {br} is {len(br)} levels deep; "
                        f"needs depth+1 <= sliding_window "
                        f"({cfg.sliding_window}): the verify commit's "
                        f"rolling scatter would alias buffer slots")
        if (speculative is not None and top_k and speculative.top_k
                and speculative.top_k != top_k):
            raise ValueError(
                f"engine top_k={top_k} conflicts with SpecConfig.top_k="
                f"{speculative.top_k}: fallback plain stepping and the "
                f"speculative acceptance rule would sample different "
                f"distributions")
        if speculative is not None and top_k and not speculative.top_k:
            # one truncation everywhere: draft, acceptance and plain steps
            speculative = replace(speculative, top_k=top_k)
        if paged is not None:
            if cfg.is_encdec or cfg.frontend:
                raise ValueError(
                    "paged KV serving needs a token-only decoder (enc-dec / "
                    "frontend archs carry cross-attention state the page "
                    "pool does not cover)")
            paged.validate(cfg, cache_capacity)
        if speculative is not None and (cfg.is_encdec or cfg.frontend):
            raise ValueError("speculative serving needs a token-only decoder "
                             "(enc-dec / frontend archs carry non-token "
                             "prompt operands the draft loop cannot feed)")
        self.cfg = cfg
        self.batch_size = batch_size
        self.cache_capacity = cache_capacity
        self.speculative = speculative
        self.temperature = float(temperature)
        self.top_k = top_k or (speculative.top_k if speculative else 0)
        self.sample_seed = sample_seed
        self.paged = paged
        # route every attention decode and verify through the fused kernels
        # — a closure flag on the step callables: same compile keys
        self.fused = bool(fused)
        self.obs = observability or Observability()
        self.metrics = self.obs.registry
        self._rec = self.obs.recorder
        self._clock = self.obs.clock
        self._counter_objs = {m: self.metrics.counter(m)
                              for m in self._COUNTER_METRICS.values()}
        self._h_prefill = self.metrics.histogram("engine_prefill_ms")
        self._h_decode = self.metrics.histogram("engine_decode_step_ms")
        self._h_spec = self.metrics.histogram("engine_spec_tick_ms")
        self.executor = (executor or LocalExecutor(device)).bind(
            cfg, batch_size, cache_capacity, paged=paged, fused=self.fused)
        self.device = self.executor.device
        self.params = self.executor.place_params(params)
        self.ctrl = controller or self.executor.make_controller(
            self.params, cfg, modes, speculative=speculative)
        self._mode_by_dw = {(m.depth, m.width): m for m in self.ctrl.modes}
        self._spec_plan = getattr(self.ctrl, "spec_plan", {})
        self.groups: Dict[int, _DepthGroup] = {}
        base_keys = sampling.make_slot_keys(sample_seed, batch_size,
                                            device=self.device)
        for d in sorted({m.depth for m in self.ctrl.modes}):
            # per-(group, slot) keys: slot i of two depth groups must not
            # share a sample stream
            g = _DepthGroup(d, self.executor.init_cache(),
                            [None] * batch_size, [1.0] * batch_size,
                            keys=sampling.fold_in(base_keys, d))
            if paged is not None:
                g.paging = _GroupPaging(paged, cfg, batch_size,
                                        cache_capacity)
            plan = self._spec_plan.get(d)
            if plan is not None:
                g.spec_k = max(plan.ks, default=0)
                if plan.trees:
                    # optimistic default until telemetry arrives: the tree
                    # with the best expected tokens per launch at high
                    # agreement (trained exits are built to agree)
                    g.spec_tree = max(
                        plan.trees,
                        key=lambda br: expected_tokens_per_tree_launch(
                            0.75, br))
                g.accept_window = deque(maxlen=speculative.window)
            self.groups[d] = g
        # acceptance telemetry per (depth, draft_depth, draft shape): feeds
        # the SLO policy's draft-shape choice and the fallback decision
        self.spec_telemetry: Dict[Tuple, SpecTelemetry] = {}
        reg = self.metrics
        self._ev_spec_fallback = reg.events(
            "engine_spec_fallback", ("step", "depth", "rate", "off_until"))
        self._ev_backpressure = reg.events(
            "engine_backpressure",
            ("step", "rid", "need", "budgeted", "reservable"))
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
        self._copy_page = (self.executor.copy_page_fn()
                           if paged is not None else None)
        # the page-table width ladder warmup builds a step for
        self._buckets = (paged.buckets(cfg, cache_capacity)
                         if paged is not None else ())
        # the buckets whose step is live now: the autoscaler retires and
        # re-adopts ladder entries through this set (never the widest, so a
        # covering bucket always exists)
        self._avail_buckets = set(self._buckets)
        self._prefills: Dict[Tuple, Callable] = {}
        # replay chunks (restore's batched re-feed of committed history),
        # keyed by (depth, chunk length); kept on the engine rather than in
        # the controller's table, since only failover replay runs them
        self._replay_chunks: Dict[Tuple[int, int], Callable] = {}
        # chunk launches of this engine's replays (host-side diagnostics;
        # restore neither snapshots nor restores it)
        self.replay_chunk_launches = 0
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
        self.spec_draft_launches = 0
        self.spec_verify_launches = 0
        self.spec_tree_launches = 0  # verify launches that scored a tree
        self.spec_generated_tokens = 0
        self.backpressure_events = 0
        # per-slot width tensors memoized by widths tuple: widths only change
        # on admission, so a steady tick makes no host-to-device copy for them
        self._active_cache: Dict[Tuple[float, ...], Dict] = {}
        # the online autoscaler (runtime.autoscale.Autoscaler.bind attaches
        # one): admission-switch events record its front's generation, and
        # a bare standby that restores a snapshot holds the snapshot's
        # autoscaler state here until one binds
        self.autoscaler = None
        self._pending_autoscale: Optional[Dict] = None

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

    def _sample(self, logits: torch.Tensor, keys: torch.Tensor) -> np.ndarray:
        """Next token per row of ``logits`` (B, Vp) on the host: argmax at
        temperature 0, else a draw from each slot's key folded with this
        tick's count."""
        if self.temperature > 0:
            nxt = sampling.sample_tokens(
                logits, sampling.fold_step(keys, self.step_count),
                self.temperature, self.cfg.vocab_size, self.top_k)
        else:
            nxt = torch.argmax(logits[:, : self.cfg.vocab_size], dim=-1)
        return nxt.cpu().numpy()

    # -- observability ------------------------------------------------------

    @property
    def spec_fallback_log(self):
        """(step, depth, rate, off_until) tuples of the
        ``engine_spec_fallback`` event stream."""
        return _TupleView(self._ev_spec_fallback)

    @property
    def backpressure_log(self):
        """Pool-exhaustion deferral events (dict rows)."""
        return self._ev_backpressure

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
        for d, stats in self.page_pool_stats().items():
            out.update({f"kv_pool_d{d}_{k}": float(v)
                        for k, v in stats.items()})
        for (d, dd, shape), t in self.spec_telemetry.items():
            if t.launches:
                out.update(t.metric_values(f"spec_d{d}_{_shape_label(shape)}"))
        return out

    def export_metrics(self, events: bool = False) -> Dict:
        return self.metrics.to_json(events=events)

    def export_trace(self) -> Dict:
        return self._rec.export_chrome_trace()

    # -- lifecycle ----------------------------------------------------------

    @torch.no_grad()
    def warmup(self) -> None:
        """Build every depth's step (and, when speculating, every draft and
        verify step, linear and tree) and run each once, then rewind.

        After this, ``self.ctrl.stats['compiles']`` is frozen at
        ``len(depths)`` plus one draft per (draft_depth, shape) and one
        verify per (depth, shape) (and, paged, one decode step per (depth,
        bucket)): width and depth churn, draft-shape switches, bucket
        changes and the fallback to plain stepping re-dispatch these steps.
        The first draft call also allocates the draft's scratch cache (a
        tree draft: its carry)."""
        self.ctrl.warmup()
        tok = self.executor.put(np.zeros((self.batch_size, 1), np.int64))
        active = self._active_for([1.0] * self.batch_size)
        mask = self.executor.put(np.ones((self.batch_size,), bool))
        for d, g in self.groups.items():
            extra = ()
            if g.paging is not None:
                # a paged engine never dispatches the dense per-depth steps:
                # run the step of every table-width bucket and the page copy
                # (free slots' rows point at scratch, so the garbage these
                # launches write is harmless)
                cache = g.cache
                for b in self._buckets:
                    fn = self.ctrl.aux_step(paged_decode_compile_key(d, b))
                    logits, cache = fn(self.params, cache, tok, active,
                                       self._table_op(g.paging, b))
                cache = self._copy_page(cache, 0, 0)
                extra = (self._table_op(g.paging, g.paging.cap_pages),)
            else:
                step = self.ctrl.step_for(self._any_mode_at(d))
                logits, cache = step(self.params, g.cache, tok, active)
            if self.temperature > 0:
                self._sample(logits[:, 0], g.keys)
            plan = self._spec_plan.get(d)
            for k in (plan.ks if plan is not None else ()):
                draft = self.ctrl.aux_step(draft_compile_key(plan.draft_depth,
                                                             k))
                verify = self.ctrl.aux_step(verify_compile_key(d, k))
                dtoks, dlg = draft(self.params, cache, tok, active, g.keys,
                                   self.temperature, 0, *extra)
                _, _, cache = verify(self.params, cache,
                                     torch.cat([tok, dtoks], dim=1), dlg,
                                     active, g.keys, self.temperature, 0,
                                     *extra)
            for br in (plan.trees if plan is not None else ()):
                draft = self.ctrl.aux_step(
                    tree_draft_compile_key(plan.draft_depth, br))
                verify = self.ctrl.aux_step(tree_verify_compile_key(d, br))
                ttoks, dlg = draft(self.params, cache, tok, active, g.keys,
                                   self.temperature, 0, *extra)
                _, _, cache = verify(self.params, cache, ttoks, dlg, active,
                                     g.keys, self.temperature, 0, *extra)
            cache = self._reset(cache, mask)
            _block_until_ready(cache)
            g.cache = self.executor.init_cache()  # warmup wrote pos 0
            if g.paging is not None:
                g.paging.host_pos[:] = 0
        self.compiles_after_warmup = self.ctrl.stats["compiles"]

    def _table_op(self, pg: _GroupPaging, width: int) -> torch.Tensor:
        """The first ``width`` columns of a group's page table, on the
        device."""
        return self.executor.put(np.ascontiguousarray(pg.table[:, :width]))

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
        if self.paged is not None:
            # reject at submit: a request whose worst case overflows the
            # page budget of every depth group could never be admitted, and
            # deferring it would starve it forever (a transient shortage is
            # deferred at admission instead)
            dyn = [g for g in self.groups.values()
                   if g.paging is not None and not g.paging.fixed]
            if dyn:
                needs = [self._worst_case_pages(g, req) for g in dyn]
                resv = min(g.paging.reservable for g in dyn)
                if min(needs) > resv:
                    raise ValueError(
                        f"request {req.rid} can never be admitted: its "
                        f"worst case needs {min(needs)} kv pages but only "
                        f"{resv} are reservable (raise --kv-pages or shrink "
                        f"the request)")
        self._queues[req.slo_class].append(req)
        if self._rec.enabled:
            self._rec.request_begin(req.rid, slo_class=req.slo_class,
                                    prompt_len=len(req.prompt),
                                    max_new_tokens=req.max_new_tokens)

    def _worst_case_pages(self, g: _DepthGroup, req: Request) -> int:
        """Pages admitting ``req`` into ``g`` can ever map at once: up to
        the highest decode write position (``prompt + new - 2``) plus the
        deepest draft shape (a linear K, a tree's level count) the group may
        speculate past it; a prefill maps
        ``plen // page_size + 1`` pages up front."""
        pg = g.paging
        plan = self._spec_plan.get(g.depth)
        headroom = 0
        if self.speculative is not None and plan is not None:
            headroom = max(list(plan.ks) + [len(br) for br in plan.trees],
                           default=0)
        last = len(req.prompt) + req.max_new_tokens - 2 + headroom
        need = max(last, len(req.prompt)) // pg.ps + 1
        return min(need, pg.cap_pages)

    def _reserve_pages(self, g: _DepthGroup, slot: int, req: Request) -> bool:
        """Book ``req``'s worst-case page demand for ``slot``; False: the
        pool cannot cover it now (the caller defers the admission)."""
        pg = g.paging
        if pg is None or pg.fixed:
            return True
        need = self._worst_case_pages(g, req)
        if not pg.can_reserve(need):
            return False
        pg.reserve(slot, need)
        return True

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
                queued_batch=len(self._queues["batch"]),
                frontier_gen=(self.autoscaler.generation
                              if self.autoscaler is not None else -1))
            self.ctrl.set_mode(mode)
        self.admission_mode = mode

    # -- one tick -----------------------------------------------------------

    def _use_prefill(self, req: Request) -> bool:
        # enc-dec / frontend archs need non-token inputs at prompt time; the
        # engine carries token prompts only, so they stay on the token feed
        # (a slot's cross K/V stay the zeros of ``init_decode_cache``)
        return (len(req.prompt) >= self.prefill_threshold
                and not self.cfg.is_encdec and not self.cfg.frontend)

    def _expire_queued(self, now_s: float) -> None:
        """Retire queued requests past their deadline (terminal
        ``expired``), against rank 0's clock on a mesh."""
        if not any(r.deadline_s is not None
                   for q in self._queues.values() for r in q):
            return
        now_s = self.executor.agree(now_s)
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
            if not self._reserve_pages(g, slot, req):
                # the page pool cannot cover this request's worst case now:
                # defer it (back to the head of its queue) and log the
                # backpressure; completions release budget
                self._queues[req.slo_class].appendleft(req)
                pg = g.paging
                self.backpressure_log.append(dict(
                    step=self.step_count, rid=req.rid,
                    need=self._worst_case_pages(g, req),
                    budgeted=pg.budgeted, reservable=pg.reservable))
                self.backpressure_events += 1
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
            if g.paging is not None:
                g.paging.host_pos[mask] = 0  # mirror the device counters
        for slot, req in prefills:
            self._admit_prefill(g, slot, req, now_s)

    def _complete(self, g: _DepthGroup, slot: int, req: Request,
                  now_s: float) -> None:
        req.finished_s = now_s
        req.status = "done"
        self.completed.append(req)
        g.slots[slot] = None
        if g.paging is not None:
            g.paging.release(slot)
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

    def _prefill_launch_paged(self, g: _DepthGroup, slot: int,
                              prompt: Tuple[int, ...]):
        """Paged whole-prompt consume with shared-prefix page reuse.

        The prompt's full pages are matched in the radix under (depth,
        width): a resident prefix is mapped into the slot's table (incref'd
        and write-masked: the prefill recomputes the same K/V for those
        positions but does not write them, so many slots share one physical
        page). Fresh pages cover the rest; then the prompt's full pages are
        inserted into the tree for the next arrival. Returns the prompt's
        last-position logits."""
        pg = g.paging
        ps = pg.ps
        plen = len(prompt)
        rkey = (g.depth, g.widths[slot])
        if pg.fixed:
            # sliding window: the dense prefill already emits the rolled
            # lane (token t at t % window), the fixed page row's layout;
            # adopt all cap_pages pages, no sharing
            ncp = pg.cap_pages
            chunks, n_full = [], 0
            pages_list = list(pg.pages[slot])
            wmask = np.ones(ncp, bool)
        else:
            ncp = min(plen // ps + 1, pg.cap_pages)
            n_full = min(plen // ps, ncp)
            chunks = [tuple(prompt[j * ps:(j + 1) * ps])
                      for j in range(n_full)]
            shared = pg.radix.match(rkey, chunks)
            for p in shared:
                pg.alloc.incref(p)
            pages_list = shared + [pg._alloc_page()
                                   for _ in range(ncp - len(shared))]
            pg.pages[slot] = list(pages_list)
            pg.table[slot, :] = pg.scratch[slot]
            pg.table[slot, :ncp] = pages_list
            wmask = np.arange(ncp) >= len(shared)
        pg.host_pos[slot] = plen
        key = ("paged", plen, g.depth)
        fn = self._prefills.get(key)
        if fn is None:
            if len(self._prefills) > 256:
                self._prefills.clear()
            fn = self.executor.prefill_adopt_fn(plen, g.depth, ncp)
            self._prefills[key] = fn
        toks = self.executor.put(np.asarray([prompt], np.int64))
        logits, g.cache = fn(self.params, toks, slot, g.cache,
                             self.executor.put(np.asarray(pages_list,
                                                          np.int64)),
                             self.executor.put(wmask))
        if not pg.fixed:
            pg.radix.insert(rkey, chunks, pages_list[:n_full])
        return logits

    def _admit_prefill(self, g: _DepthGroup, slot: int, req: Request,
                       now_s: float) -> None:
        """Consume the whole prompt in one prefill + adoption."""
        self.executor.launch("prefill")
        t0 = self._clock()
        if g.paging is not None:
            logits = self._prefill_launch_paged(g, slot, req.prompt)
        else:
            logits = self._prefill_launch(g, slot, req.prompt)
        req.prefilled = True
        # the prefill's last-position logits yield the first generated token,
        # from the slot's own sample stream when sampling
        nxt = int(self._sample(logits[:, 0], g.keys[slot:slot + 1])[0])
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

    def _spec_select(self, g: _DepthGroup):
        """The draft shape to speculate with this tick: ``("tree",
        branching)``, ``("linear", k)``, or ``None`` (plain step). A group
        speculates only when the depth has a shallower exit, speculation is
        not cooling off after an acceptance collapse, and every active slot
        has fed its prompt up to the last token and has draft-depth + 1
        cache positions of headroom. The active token tree (``spec_tree``)
        takes precedence over the linear draft length."""
        if self.speculative is None or g.depth not in self._spec_plan:
            return None
        if self.step_count < g.spec_off_until:
            return None
        if g.spec_tree is not None:
            sel, draft_depth = ("tree", g.spec_tree), len(g.spec_tree)
        elif g.spec_k > 0:
            sel, draft_depth = ("linear", g.spec_k), g.spec_k
        else:
            return None
        for r in g.slots:
            if r is None:
                continue
            if r.fed < len(r.prompt) - 1:
                return None
            if r.fed + draft_depth + 1 > self.cache_capacity:
                return None
        return sel

    def _spec_tick(self, g: _DepthGroup, sel, active_ix: List[int],
                   now_s: float) -> float:
        """One speculative step for a depth group: draft at the shallow exit
        (a linear K-token chain or a token tree), verify every position in
        one full-depth pass and commit the accepted prefix or path on the
        device. ONE host transfer brings back (out_tokens, n_accepted) for
        the slot bookkeeping."""
        plan = self._spec_plan[g.depth]
        kind, shape = sel
        site = "tree_verify" if kind == "tree" else "verify"
        self.executor.launch(site)
        if kind == "tree":
            draft = self.ctrl.aux_step(
                tree_draft_compile_key(plan.draft_depth, shape))
            vkey = tree_verify_compile_key(g.depth, shape)
            depth_budget = len(shape)  # most drafts one launch accepts
        else:
            draft = self.ctrl.aux_step(draft_compile_key(plan.draft_depth,
                                                         shape))
            vkey = verify_compile_key(g.depth, shape)
            depth_budget = shape
        verify = self.ctrl.aux_step(vkey)
        toks = np.zeros((self.batch_size, 1), np.int64)
        for i in active_ix:
            toks[i, 0] = g.slots[i].next_input()
        active = self._active_for(g.widths)
        tok_op = self.executor.put(toks)
        pg = g.paging
        extra = ()
        if pg is not None:
            # grow every active slot's mapping to cover the deepest draft
            # write (root + depth_budget positions) and privatize any shared
            # page in that range; draft and verify read the full-width table
            for i in active_ix:
                pos = int(pg.host_pos[i])
                pg.ensure_slot(i, pos + depth_budget)
                for src, dst in pg.cow_pairs(i, pos, pos + depth_budget):
                    g.cache = self._copy_page(g.cache, src, dst)
            extra = (self._table_op(pg, pg.cap_pages),)
        t0 = self._clock()
        dtoks, dlg = draft(self.params, g.cache, tok_op, active, g.keys,
                           self.temperature, self.step_count, *extra)
        vtoks = dtoks if kind == "tree" else torch.cat([tok_op, dtoks], dim=1)
        out, n_acc, g.cache = verify(self.params, g.cache, vtoks, dlg, active,
                                     g.keys, self.temperature,
                                     self.step_count, *extra)
        both = torch.cat([out, n_acc[:, None]], dim=1).cpu().numpy()
        out_h, n_acc_h = both[:, :-1], both[:, -1]
        _block_until_ready(g.cache)
        dt = self._clock() - t0
        self.ctrl.stats["dispatches"] += 2
        self.ctrl.last_step_s = dt
        self.spec_draft_launches += 1
        self.spec_verify_launches += 1
        self.spec_tree_launches += kind == "tree"
        if pg is not None:
            # mirror commit_verify: pos += n_accepted + 1 for every slot
            # (free slots drift harmlessly; admission resets both counters)
            pg.host_pos += np.asarray(n_acc_h, np.int64) + 1

        rec_on = self._rec.enabled
        rids = [g.slots[i].rid for i in active_ix] if rec_on else None
        produced = 0
        for i in active_ix:
            req = g.slots[i]
            for j in range(int(n_acc_h[i]) + 1):
                if req.done:
                    break
                req.fed += 1
                if req.fed >= len(req.prompt):
                    req.generated.append(int(out_h[i, j]))
                    produced += 1
                    if rec_on and len(req.generated) == 1:
                        self._rec.request_event(req.rid, "first_token")
            if req.done:
                self._complete(g, i, req, now_s)
            elif pg is not None:
                pg.trim(i)  # rollback: pages grown for rejected drafts free
        self.spec_generated_tokens += produced
        self._h_spec.observe(dt * 1e3)
        if rec_on:
            self._rec.launch(
                site, t0, t0 + dt, depth=g.depth, rids=rids,
                occupancy=len(active_ix), tokens=produced,
                widths=[g.widths[i] for i in active_ix], key=list(vkey))

        # speculative tick time lives in the SPEC telemetry only: the
        # controller's per-mode p50 is the SLO policy's per-decode-step
        # estimate, which a multi-token tick would inflate
        tree = shape if kind == "tree" else None
        tel = self.spec_telemetry.setdefault(
            (g.depth, plan.draft_depth, shape),
            SpecTelemetry(k=depth_budget, tree=tree,
                          nodes=tree_node_budget(shape) if tree else shape))
        tel.record([int(n_acc_h[i]) for i in active_ix], len(active_ix), dt)
        # window entries are PER-CANDIDATE acceptance: a tree's depth
        # fraction measures per-level survival and is inverted, so tree and
        # linear ticks feed the policy and the collapse threshold one number
        g.accept_window.append(per_candidate_accept_rate(
            float(np.mean([n_acc_h[i] for i in active_ix])) / depth_budget,
            tree))
        spec = self.speculative
        if (len(g.accept_window) == g.accept_window.maxlen
                and float(np.mean(g.accept_window)) < spec.min_accept_rate):
            # acceptance collapsed: drafts cost launches without yielding
            # tokens — plain stepping until the cooloff ends
            g.spec_off_until = self.step_count + spec.cooloff_ticks
            self._ev_spec_fallback.emit(
                step=self.step_count, depth=g.depth,
                rate=float(np.mean(g.accept_window)),
                off_until=g.spec_off_until)
            g.accept_window.clear()
        return dt

    @torch.no_grad()
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
            sel = self._spec_select(g)
            if sel is not None:
                spent += self._spec_tick(g, sel, active_ix, now_s)
                continue
            if g.paging is not None:
                spent += self._paged_tick(g, active_ix, now_s)
                continue
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
            nxt = self._sample(logits[:, 0], g.keys)
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

    def _paged_tick(self, g: _DepthGroup, active_ix: List[int],
                    now_s: float) -> float:
        """One plain decode tick through the bucketed paged step: host page
        bookkeeping first (grow each active slot's mapping to its write
        position, copy any shared page in range), then ONE call of the
        ``("paged_decode", depth, bucket)`` step, bucket the smallest table
        width covering every active slot."""
        self.executor.launch("paged_decode")
        pg = g.paging
        needed = 1
        for i in active_ix:
            pos = int(pg.host_pos[i])
            pg.ensure_slot(i, pos)
            for src, dst in pg.cow_pairs(i, pos, pos):
                g.cache = self._copy_page(g.cache, src, dst)
            needed = max(needed, min(pos // pg.ps + 1, pg.cap_pages))
        bucket = self._bucket_for(needed)
        pages_op = self._table_op(pg, bucket)
        toks = np.zeros((self.batch_size, 1), np.int64)
        for i in active_ix:
            toks[i, 0] = g.slots[i].next_input()
        active = self._active_for(g.widths)
        w_max = max(g.widths[i] for i in active_ix)
        mode = self._mode_by_dw[(g.depth, w_max)]
        fn = self.ctrl.aux_step(paged_decode_compile_key(g.depth, bucket))
        self.ctrl.stats["dispatches"] += 1
        rec_on = self._rec.enabled
        rids = [g.slots[i].rid for i in active_ix] if rec_on else None
        t0 = self._clock()
        logits, g.cache = fn(self.params, g.cache, self.executor.put(toks),
                             active, pages_op)
        _block_until_ready((logits, g.cache))
        dt = self._clock() - t0
        self.ctrl.telemetry[mode.name].record(dt, len(active_ix))
        self.ctrl.last_step_s = dt
        self._h_decode.observe(dt * 1e3)
        pg.host_pos += 1  # mirror the device counter (every slot advances)
        self.decode_launches += 1
        self.per_mode_launch_equiv += len(
            {(g.depth, g.widths[i]) for i in active_ix})
        nxt = self._sample(logits[:, 0], g.keys)
        produced = 0
        for i in active_ix:
            req = g.slots[i]
            req.fed += 1
            if req.fed >= len(req.prompt) and not req.done:
                req.generated.append(int(nxt[i]))
                produced += 1
                if rec_on and len(req.generated) == 1:
                    self._rec.request_event(req.rid, "first_token")
            if req.done:
                self._complete(g, i, req, now_s)
        if rec_on:
            self._rec.launch(
                "paged_decode", t0, t0 + dt, depth=g.depth, rids=rids,
                occupancy=len(active_ix), tokens=produced, bucket=bucket,
                widths=[g.widths[i] for i in active_ix],
                key=list(paged_decode_compile_key(g.depth, bucket)))
        return dt

    # -- page-pool accounting ----------------------------------------------

    def _bucket_for(self, needed: int) -> int:
        """The narrowest LIVE page-table bucket covering ``needed`` pages.
        The ladder entry ``PagedLayout.bucket_for`` would pick may have
        been retired by the autoscaler; rounding up to the next live bucket
        is bit-identical (the extra table columns point at scratch, as a
        free slot's do, and every paged step plans for the widest bucket).
        The widest bucket is never retired."""
        return min(b for b in self._avail_buckets if b >= needed)

    def check_paged_invariants(self) -> None:
        """Assert exact page accounting in every depth group (no leaks, no
        double assignment, no refcount drift). A no-op for dense engines."""
        for g in self.groups.values():
            if g.paging is not None:
                g.paging.check_invariants()

    def page_pool_stats(self) -> Dict[int, Dict[str, float]]:
        """Per-depth-group pool occupancy and radix telemetry (empty when
        dense)."""
        return {d: g.paging.stats() for d, g in self.groups.items()
                if g.paging is not None}

    # -- snapshot / restore (fault tolerance) -------------------------------

    def snapshot(self) -> EngineSnapshot:
        """Cut the host-side truth needed to rebuild device state: a deep
        copy of the requests and the scalar counters, nothing on the
        device, so a supervisor can cut one before every tick (that cadence
        is what makes failover replay exact: the interrupted tick is redone
        whole). Raises for encoder-decoder and frontend models: replay
        re-feeds committed tokens, and their prompts carry non-token
        operands the engine does not keep."""
        if self.cfg.is_encdec or self.cfg.frontend:
            raise ValueError(
                "snapshot/restore needs a token-only decoder (enc-dec / "
                "frontend prompts carry non-token operands replay cannot "
                "re-feed)")
        groups = {}
        for d, g in self.groups.items():
            groups[d] = GroupSnapshot(
                depth=d,
                slots=copy.deepcopy(g.slots),
                widths=list(g.widths),
                spec_k=g.spec_k,
                spec_tree=g.spec_tree,
                spec_off_until=g.spec_off_until,
                accept_window=list(g.accept_window or ()),
                accept_window_maxlen=(g.accept_window.maxlen
                                      if g.accept_window is not None
                                      else None),
            )
        counters = {attr: getattr(self, attr)
                    for attr in self._COUNTER_METRICS}
        logs = dict(
            admission_switch_log=copy.deepcopy(
                list(self._ev_admission_switch.rows)),
            admission_decision_log=copy.deepcopy(
                list(self._ev_admission_decision.rows)),
            spec_fallback_log=list(self.spec_fallback_log),
            backpressure_log=copy.deepcopy(list(self._ev_backpressure.rows)),
        )
        return EngineSnapshot(
            step_count=self.step_count,
            admission_mode=self.admission_mode.name,
            queues={c: copy.deepcopy(list(q))
                    for c, q in self._queues.items()},
            completed=copy.deepcopy(self.completed),
            expired=copy.deepcopy(self.expired),
            groups=groups,
            counters=counters,
            logs=logs,
            telemetry=self.ctrl.telemetry_state(),
            spec_telemetry=copy.deepcopy(self.spec_telemetry),
            paging_stats=self.page_pool_stats(),
            metrics=self.obs.state_dict(),
            autoscale=(self.autoscaler.state_dict()
                       if self.autoscaler is not None else None),
        )

    @torch.no_grad()
    def restore(self, snap: EngineSnapshot) -> None:
        """Rebuild this engine's whole serving state from ``snap``.

        The engine must be geometry-compatible with the snapshot's source:
        the same mode table, batch size, capacity, paged layout,
        speculative plan and sample seed, i.e. another engine from the same
        factory (per-slot sample keys come from the seed, and restoring
        ``step_count`` keeps every slot's ``fold_step`` stream). All
        existing state is discarded, so a warm standby can absorb failovers
        again and again. Caches are re-made by ``_replay_group``; counters,
        logs, telemetry and metrics are applied LAST, so replay launches
        never leak into the restored accounting: the redone tick re-earns
        its increments and the totals after recovery match a fault-free
        run's."""
        if snap.admission_mode not in self.ctrl.mode_by_name:
            raise ValueError(f"snapshot admission mode "
                             f"{snap.admission_mode!r} not in this engine's "
                             f"mode table")
        if set(snap.groups) != set(self.groups):
            raise ValueError(f"snapshot depth groups "
                             f"{sorted(snap.groups)} do not match this "
                             f"engine's {sorted(self.groups)}")
        for gs in snap.groups.values():
            if len(gs.slots) != self.batch_size:
                raise ValueError(f"snapshot batch size {len(gs.slots)} != "
                                 f"engine batch size {self.batch_size}")
        self.step_count = snap.step_count
        mode = self.ctrl.mode_by_name[snap.admission_mode]
        self.admission_mode = mode
        self.ctrl.force_mode(mode)
        self._queues = {c: deque(copy.deepcopy(snap.queues.get(c, [])))
                        for c in SLO_CLASSES}
        self.completed = copy.deepcopy(snap.completed)
        self.expired = copy.deepcopy(snap.expired)
        for d, gs in snap.groups.items():
            g = self.groups[d]
            g.slots = copy.deepcopy(gs.slots)
            g.widths = list(gs.widths)
            g.spec_k = gs.spec_k
            g.spec_tree = gs.spec_tree
            g.spec_off_until = gs.spec_off_until
            g.accept_window = (deque(gs.accept_window,
                                     maxlen=gs.accept_window_maxlen)
                               if gs.accept_window_maxlen is not None
                               else None)
            g.cache = self.executor.init_cache()
            if self.paged is not None:
                g.paging = _GroupPaging(self.paged, self.cfg,
                                        self.batch_size,
                                        self.cache_capacity)
                for i, r in enumerate(g.slots):
                    if r is not None:
                        booked = self._reserve_pages(g, i, r)
                        assert booked, (
                            f"restore: slot {i} budget cannot be re-booked "
                            f"on a fresh pool")
            self._replay_group(g)
        for attr, v in snap.counters.items():
            setattr(self, attr, v)
        for stream, key in ((self._ev_admission_switch,
                             "admission_switch_log"),
                            (self._ev_admission_decision,
                             "admission_decision_log"),
                            (self._ev_backpressure, "backpressure_log")):
            stream.rows = deque(copy.deepcopy(snap.logs[key]),
                                maxlen=stream.rows.maxlen)
        fb = self._ev_spec_fallback
        fb.rows = deque((dict(zip(fb.fields, t))
                         for t in snap.logs["spec_fallback_log"]),
                        maxlen=fb.rows.maxlen)
        self.ctrl.load_telemetry_state(snap.telemetry)
        self.spec_telemetry = copy.deepcopy(snap.spec_telemetry)
        if snap.metrics is not None:
            # metrics and trace state come back whole and LAST, so whatever
            # the replay above recorded is discarded: the redone tick
            # re-earns it, and exports after recovery equal a fault-free
            # run's
            self.obs.load_state(snap.metrics)
        # the gauge callback must be THIS engine's (the standby that took
        # the snapshot, not the dead source); the key replaces any stale
        # registration on a shared registry
        self.metrics.register_callback(self._metric_gauges, key="engine")
        if snap.autoscale is not None:
            if self.autoscaler is not None:
                # rebuild the published and retired pool, so the next
                # generation decides as the source's would have (the
                # recovery path: synchronous builds are allowed)
                self.autoscaler.load_state(snap.autoscale)
            else:
                # a bare standby holds the state until an Autoscaler binds
                # (Autoscaler.bind applies it); the groups may name draft
                # shapes this table lacks, so a bind must come before the
                # next speculative tick
                self._pending_autoscale = copy.deepcopy(snap.autoscale)
        if self._rec.enabled:
            for g in self.groups.values():
                for r in g.slots:
                    if r is not None:
                        self._rec.request_event(
                            r.rid, "failover_replay",
                            committed=r.fed, generated=len(r.generated))

    def _replay_prefill(self, g: _DepthGroup, slot: int,
                        req: Request) -> None:
        # the same prefill and page mapping the admission used, so the
        # prompt's K/V (and any radix page sharing) come back identical; a
        # replay is no new admission: no counters, no sampling (the first
        # generated token is already in ``req.generated``)
        if g.paging is not None:
            self._prefill_launch_paged(g, slot, req.prompt)
        else:
            self._prefill_launch(g, slot, req.prompt)

    def _replay_launch(self, g: _DepthGroup, toks: np.ndarray,
                       joined: List[int]) -> None:
        """One lockstep one-token launch of the replay, through the steps
        normal ticks use (the per-depth dense step or the bucketed paged
        step). Every slot's device position advances by one; a paged host
        mirror advances with it. Only JOINED slots get their mappings
        grown: a slot that has not joined yet writes its garbage to its
        scratch page, as a free slot does on normal ticks."""
        active = self._active_for(g.widths)
        pg = g.paging
        if pg is not None:
            needed = 1
            for i in joined:
                pos = int(pg.host_pos[i])
                pg.ensure_slot(i, pos)
                for src, dst in pg.cow_pairs(i, pos, pos):
                    g.cache = self._copy_page(g.cache, src, dst)
                needed = max(needed, min(pos // pg.ps + 1, pg.cap_pages))
            bucket = self._bucket_for(needed)
            fn = self.ctrl.aux_step(paged_decode_compile_key(g.depth,
                                                             bucket))
            _, g.cache = fn(self.params, g.cache, self.executor.put(toks),
                            active, self._table_op(pg, bucket))
            pg.host_pos += 1  # mirror the device counter (ALL slots advance)
        else:
            fn = self.ctrl.step_for(self._any_mode_at(g.depth))
            _, g.cache = fn(self.params, g.cache, self.executor.put(toks),
                            active)
        self.ctrl.stats["dispatches"] += 1

    def _replay_chunk(self, g: _DepthGroup, toks: np.ndarray,
                      joined: List[int]) -> None:
        """One batched replay launch: C >= 2 committed tokens per joined
        slot are verify-scored and force-committed (``n_accepted = C - 1``)
        in ONE pass, as C lockstep ``_replay_launch`` calls would leave the
        cache, C - 1 launches cheaper. Every slot's device position
        advances by C (slots that have not joined take garbage writes, as
        under the one-token lockstep); paged mappings are grown and
        privatized over the whole C-token write range first."""
        C = toks.shape[1]
        active = self._active_for(g.widths)
        pg = g.paging
        extra = ()
        if pg is not None:
            for i in joined:
                pos = int(pg.host_pos[i])
                pg.ensure_slot(i, pos + C - 1)
                for src, dst in pg.cow_pairs(i, pos, pos + C - 1):
                    g.cache = self._copy_page(g.cache, src, dst)
            # chunks are cached per (depth, C), not bucketed: replay ships
            # the full-width table, as the speculative steps do
            extra = (self._table_op(pg, pg.cap_pages),)
        key = (g.depth, C)
        fn = self._replay_chunks.get(key)
        if fn is None:
            fn = self.executor.replay_chunk_fn(g.depth, C)
            self._replay_chunks[key] = fn
        g.cache = fn(self.params, g.cache, self.executor.put(toks), active,
                     *extra)
        if pg is not None:
            pg.host_pos += C  # mirror the device counter (ALL slots advance)
        self.ctrl.stats["dispatches"] += 1
        self.replay_chunk_launches += 1

    def _replay_group(self, g: _DepthGroup) -> None:
        """Re-make one depth group's cache from host truth.

        A live slot's committed stream is ``(prompt + generated)[:fed]``
        (its cache position always equals ``fed``). A slot admitted through
        prefill replays its prompt through the same prefill; everything
        token-fed (short prompts, every decode- or verify-committed token)
        is re-fed through the group's own steps at the slot's admitted
        width. That split matters: a prefill is width-blind (full-width
        K/V), so a narrow slot's token-fed history must come back through
        the width-gated steps.

        Feeds are staggered to END together: slot ``i`` joins the lockstep
        at launch ``T - tail_i`` (reset to position 0, or prefilled to
        ``plen``) and feeds its remaining tokens in order, so each launch
        advances every joined slot and each lands at ``pos == fed``. Slots
        not joined yet and free slots take garbage writes meanwhile (dense:
        masked by position after their reset or adoption; paged: routed to
        scratch pages), as normal admission recycles slots. Between joins
        the feed is batched: up to ``c_max`` tokens ride one
        ``_replay_chunk`` (bounded by a sliding window, whose rolling
        scatter must not alias)."""
        live = [(i, r) for i, r in enumerate(g.slots) if r is not None]
        pg = g.paging
        if not live:
            return
        tails: Dict[int, Tuple[int, Tuple[int, ...]]] = {}
        for i, r in live:
            committed = (tuple(r.prompt) + tuple(r.generated))[:r.fed]
            if r.prefilled:
                tails[i] = (len(r.prompt), committed[len(r.prompt):])
            else:
                tails[i] = (0, committed)
        T = max(len(t) for _, t in tails.values())
        c_max = max(min(8, self.cfg.sliding_window or 8), 1)
        joined: List[int] = []
        t = 0
        while t < T:
            mask = np.zeros(self.batch_size, bool)
            for i, (_, tail) in tails.items():
                if T - len(tail) != t:
                    continue
                r = g.slots[i]
                if r.prefilled:
                    self._replay_prefill(g, i, r)  # pos := plen
                else:
                    mask[i] = True  # pos := 0
                    if pg is not None:
                        pg.host_pos[i] = 0
                joined.append(i)
            if mask.any():
                g.cache = self._reset(g.cache, self.executor.put(mask))
            # feed until the next slot joins (or the end), in chunks
            waiting = [T - len(tail) for i2, (_, tail) in tails.items()
                       if i2 not in joined]
            t_next = min([w for w in waiting if w > t], default=T)
            while t < t_next:
                C = min(c_max, t_next - t)
                toks = np.zeros((self.batch_size, C), np.int64)
                for i in joined:
                    _, tail = tails[i]
                    off = t - (T - len(tail))
                    toks[i, :] = tail[off:off + C]
                if C == 1:
                    self._replay_launch(g, toks, joined)
                else:
                    self._replay_chunk(g, toks, joined)
                t += C
        # slots with nothing to feed: fed == 0 (a plain reset) or a
        # prefilled prompt with no generation fed past it (adopted after
        # the launches, so the lockstep cannot move its position)
        end_mask = np.zeros(self.batch_size, bool)
        for i, (_, tail) in tails.items():
            if tail:
                continue
            r = g.slots[i]
            if r.prefilled:
                self._replay_prefill(g, i, r)
            else:
                end_mask[i] = True
                if pg is not None:
                    pg.host_pos[i] = 0
        # free slots took garbage advances during the lockstep; rewind them
        # (admission would reset them anyway; this keeps the device and the
        # host mirrors exact for the invariant checks)
        for i in range(self.batch_size):
            if g.slots[i] is None:
                end_mask[i] = True
                if pg is not None:
                    pg.host_pos[i] = 0
        if end_mask.any():
            g.cache = self._reset(g.cache, self.executor.put(end_mask))
        _block_until_ready(g.cache)
        if pg is not None:
            for i, r in live:
                assert int(pg.host_pos[i]) == r.fed, (
                    f"replay drift: slot {i} at pos {int(pg.host_pos[i])} "
                    f"!= fed {r.fed}")

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
        spec_v0 = self.spec_verify_launches
        spec_t0 = self.spec_tree_launches
        spec_tok0 = self.spec_generated_tokens
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
                if self.speculative is not None:
                    self._retune_spec(policy, qd)
            # the virtual clock decides admissions: rank 0's on a mesh
            dt = self.executor.agree(self.step(now_s=clock))
            busy += dt
            clock += dt
        total_generated = self._generated_total() - generated0
        launches = self.decode_launches - launches0
        ticks = self.ticks_with_work - ticks0
        prefill_s = self.prefill_s - prefill_s0
        prefill_toks = self.prefill_prompt_tokens - prefill_toks0
        spec_v = self.spec_verify_launches - spec_v0
        spec_tok = self.spec_generated_tokens - spec_tok0
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
            # speculative decoding: verify launches and the tokens they
            # emitted (tokens/launch > 1 is the decode-launch reduction)
            "spec_verify_launches": spec_v,
            "spec_tree_launches": self.spec_tree_launches - spec_t0,
            "spec_generated_tokens": spec_tok,
            "spec_tokens_per_launch": spec_tok / spec_v if spec_v else 0.0,
            "spec_fallbacks": len(self.spec_fallback_log),
            "expired": len(self.expired) - expired0,
        }

    def _retune_spec(self, policy: SLOPolicy,
                     queue_depths: Dict[str, int]) -> None:
        """Let the SLO policy re-pick each group's draft shape (a token
        tree, a linear K, or plain stepping) from the built table, at the
        measured per-candidate acceptance (rolling window first, lifetime
        telemetry second, an optimistic 0.75 before any data)."""
        spec = self.speculative
        for g in self.groups.values():
            plan = self._spec_plan.get(g.depth)
            if plan is None:
                continue
            if g.accept_window:
                rate = float(np.mean(g.accept_window))
            else:
                # each path's depth fraction converted to the per-candidate
                # rate first: tree and linear denominators differ
                tels = [t for (d, _, _), t in self.spec_telemetry.items()
                        if d == g.depth and t.drafted]
                rate = (sum(per_candidate_accept_rate(t.accepted / t.drafted,
                                                      t.tree)
                            * t.slot_launches for t in tels)
                        / sum(t.slot_launches for t in tels)) if tels else 0.75
            if plan.trees:
                kind, shape = policy.choose_tree(
                    plan.trees, plan.ks, rate, queue_depths,
                    min_accept_rate=spec.min_accept_rate)
                if kind == "tree":
                    g.spec_tree, g.spec_k = shape, 0
                elif kind == "linear":
                    g.spec_tree, g.spec_k = None, shape
                elif g.accept_window:
                    # plain stepping, on fresh window evidence only: cool
                    # off as the in-tick collapse fallback does, keeping the
                    # shapes so the group re-probes afterwards (a stale
                    # lifetime rate must not extend the cooloff forever)
                    g.spec_off_until = max(g.spec_off_until,
                                           self.step_count
                                           + spec.cooloff_ticks)
                    g.accept_window.clear()
            else:
                g.spec_tree = None
                g.spec_k = policy.choose_spec_k(plan.ks, rate, queue_depths)

    def spec_telemetry_summary(self) -> Dict[str, Dict[str, float]]:
        """Acceptance telemetry per (depth, draft_depth, draft shape) path
        (``k...`` linear draft lengths, ``t...`` tree schedules)."""
        return {f"d{d}<-d{dd}{_shape_label(s)}": t.summary()
                for (d, dd, s), t in self.spec_telemetry.items()
                if t.launches}


def _counter_property(metric: str) -> property:
    def _get(self):
        return self._counter_objs[metric].value

    def _set(self, v):
        self._counter_objs[metric].set(v)

    return property(_get, _set)


for _attr, _metric in ServingEngine._COUNTER_METRICS.items():
    setattr(ServingEngine, _attr, _counter_property(_metric))
del _attr, _metric
