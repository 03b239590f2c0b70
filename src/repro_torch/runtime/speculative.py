"""Self-speculative decoding: shallow DistillCycle exits draft for the full model.

Port of ``repro.runtime.speculative`` (linear drafts). A shallow exit depth
drafts K tokens (K one-token decode steps over the first ``draft_depth``
layer groups), then the serving depth scores all K+1 positions in ONE
``verify_step`` pass and commits the accepted prefix with masked in-place
writes (``commit_verify``). Weights and the per-slot cache are shared; the
accepted stream is distribution-identical to running the verifier alone,
and token for token identical under greedy decoding.

* ``make_draft_step`` — K decode steps at the draft depth. JAX drafts on a
  scan-carried copy of the cache and discards it; the port's decode writes
  in place, so the draft runs on a SCRATCH copy of the first
  ``draft_depth`` groups' K/V and ``pos``, allocated once (at the first
  call, which the engine's warmup makes) and refilled with ``copy_`` per
  draft. The committed cache is never touched; over a block-paged cache
  the scratch holds a copy of the page pools, so draft writes never reach
  the committed pool.
* ``make_verify_step`` — ``verify_step`` + the acceptance rule +
  ``commit_verify``; ``n_accepted`` stays on the device from logits to the
  commit, so a tick reads ``(out_tokens, n_accepted)`` back once.

The acceptance rule is the standard speculative rejection sampler with
per-slot keys (``runtime.sampling``); at temperature 0 the distributions
are one-hot and the same arithmetic is exactly greedy acceptance.

Token trees (``TreeTopology``, ``accept_tree``, tree draft and verify,
``SpecConfig.trees``) arrive with the tree slice of the port and raise.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import commit_verify, decode_step, verify_step
from repro_torch.runtime import sampling

# stream ids folded into the per-launch slot keys so every random use is
# disjoint: draft position j uses (DRAFT, j); acceptance uniforms ACCEPT;
# the replacement/bonus sample BONUS.
_STREAM_DRAFT = 1
_STREAM_ACCEPT = 2
_STREAM_BONUS = 3

_TREE_SLICE = "token trees arrive with the tree slice of the port"


def draft_compile_key(draft_depth: int, k: int) -> Tuple:
    return ("spec_draft", draft_depth, k)


def verify_compile_key(depth: int, k: int) -> Tuple:
    return ("spec_verify", depth, k)


class TreeTopology:
    """Static token-tree shape: arrives with the tree slice of the port
    (``repro.runtime.speculative.TreeTopology`` is its reference)."""

    def __init__(self, branching: Tuple[int, ...]):
        raise NotImplementedError(_TREE_SLICE)


def accept_tree(*args, **kwargs):
    """Token-tree rejection sampling: arrives with the tree slice."""
    raise NotImplementedError(_TREE_SLICE)


@dataclass(frozen=True)
class SpecConfig:
    """Speculative serving configuration (engine-level policy knobs).

    ``ks`` is the draft-length table: one draft step per (draft_depth, K)
    and one verify step per (depth, K) are built at warmup, and the SLO
    policy may switch between them at runtime without building anything.
    ``draft_depth`` pins the drafting exit; None picks the deepest exit
    shallower than each serving depth. When the mean accepted/K over a
    ``window``-launch rolling window falls below ``min_accept_rate``, the
    group falls back to plain stepping for ``cooloff_ticks`` ticks.
    ``trees`` (token-tree schedules) must stay empty in this slice."""

    ks: Tuple[int, ...] = (4,)
    trees: Tuple[Tuple[int, ...], ...] = ()
    draft_depth: Optional[int] = None
    min_accept_rate: float = 0.05
    window: int = 32
    cooloff_ticks: int = 200
    top_k: int = 0

    def __post_init__(self):
        if self.trees:
            raise NotImplementedError(f"SpecConfig.trees: {_TREE_SLICE}")


@dataclass(frozen=True)
class SpecPlanEntry:
    """Resolved speculative wiring for one serving depth."""

    depth: int
    draft_depth: int
    ks: Tuple[int, ...]


def spec_plan(depths, spec: SpecConfig) -> Dict[int, SpecPlanEntry]:
    """Resolve (serving depth -> draft depth, K table) over the mode table.
    Only depths with a strictly shallower depth can speculate (the
    shallowest keeps plain stepping); an explicit ``spec.draft_depth`` is
    honoured wherever it is shallower than the serving depth."""
    if not spec.ks:
        raise ValueError("SpecConfig needs at least one linear draft length "
                         "in `ks`")
    depths = sorted(set(depths))
    plan: Dict[int, SpecPlanEntry] = {}
    for d in depths:
        cands = [e for e in depths if e < d]
        if spec.draft_depth is not None:
            cands = [e for e in cands if e == spec.draft_depth]
        if cands:
            plan[d] = SpecPlanEntry(depth=d, draft_depth=max(cands),
                                    ks=tuple(sorted(set(spec.ks))))
    return plan


# ---------------------------------------------------------------------------
# acceptance rule
# ---------------------------------------------------------------------------


def accept_speculative(logits, draft_logits, tokens, keys, temperature: float,
                       vocab: int, top_k: int = 0):
    """Speculative rejection sampling over a drafted window.

    logits: (B, S, Vp) verifier scores (row j = distribution after
    tokens[:, :j+1]); draft_logits: (B, S-1, Vp) the distributions the K
    drafts were sampled from; tokens: (B, S) last committed token + K
    drafts; keys: (B,) per-launch slot keys. Returns (out_tokens (B, S),
    n_accepted (B,)), both on the device: ``out_tokens[:, :n+1]`` is the
    generated stream (n accepted drafts + one replacement/bonus token)."""
    B, S = tokens.shape
    K = S - 1
    dev = logits.device
    p = sampling.token_dist(logits, temperature, vocab, top_k)  # (B, S, V)
    q = sampling.token_dist(draft_logits, temperature, vocab, top_k)
    d = tokens[:, 1:].long()
    p_d = p[:, :K].gather(-1, d[..., None])[..., 0]
    q_d = q.gather(-1, d[..., None])[..., 0]
    u = sampling.uniform(sampling.fold_in(keys, _STREAM_ACCEPT), K)  # (B, K)
    # accept iff u < p(d)/q(d), division-free (q_d may be 0 under top-k)
    accept = u * q_d < p_d
    n_acc = torch.cumprod(accept.long(), dim=1).sum(1)  # leading accepts
    # replacement (first rejection) / bonus (all accepted): normalize(max(p
    # - q, 0)) at position n_acc, q padded with zeros at j = K
    q_pad = torch.cat([q, torch.zeros_like(q[:, :1])], dim=1)
    ix = n_acc[:, None, None].expand(B, 1, p.shape[-1])
    p_at = p.gather(1, ix)[:, 0]
    q_at = q_pad.gather(1, ix)[:, 0]
    res = torch.clamp(p_at - q_at, min=0.0)
    rs = res.sum(-1, keepdim=True)
    res = torch.where(rs > 0, res / torch.clamp(rs, min=1e-38), p_at)
    if temperature > 0:
        last = sampling.categorical(sampling.fold_in(keys, _STREAM_BONUS), res)
    else:
        last = res.argmax(-1)
    j = torch.arange(S, device=dev)[None, :]
    d_pad = torch.cat([d, torch.zeros_like(d[:, :1])], dim=1)
    out = torch.where(j < n_acc[:, None], d_pad, last[:, None])
    return out, n_acc


# ---------------------------------------------------------------------------
# step builders (built by core.morph.make_serve_controller)
# ---------------------------------------------------------------------------


class DraftStep:
    """K-token drafting at one exit depth, on a scratch copy of the cache.

    ``draft(params, cache, tok0, active, keys, temperature, step[, pages])
    -> (draft_tokens (B, K), draft_logits (B, K, Vp))``. ``load_scratch``
    copies the first ``draft_depth`` groups of every cache leaf (K/V or
    their page pools, or an SSM layer's conv tails and state) and ``pos`` of
    ``cache`` into the scratch (allocated at the first call) and returns
    it. With ``page_size`` > 0 the cache is block-paged and ``pages`` is
    the (B, P) page table the draft reads and writes the scratch pool
    through."""

    def __init__(self, cfg: ModelConfig, draft_depth: int, k: int,
                 top_k: int = 0, page_size: int = 0, plan_len: int = 0,
                 fused: bool = False):
        self.cfg, self.draft_depth, self.k = cfg, draft_depth, k
        self.top_k, self.fused = top_k, fused
        self.page_size, self.plan_len = page_size, plan_len
        self.scratch: Optional[Dict] = None
        self._layout = None  # (shape, dtype, device) of every cache leaf

    def load_scratch(self, cache) -> Dict:
        dd = self.draft_depth
        layout = [(t.shape, t.dtype, t.device) for t in
                  [cache["pos"]] + [t for layer in cache["stack"].values()
                                    for t in layer.values()]]
        if layout != self._layout:
            self.scratch = {"pos": torch.empty_like(cache["pos"]),
                            "stack": {pn: {key: torch.empty_like(t[:dd])
                                           for key, t in layer.items()}
                                      for pn, layer in cache["stack"].items()}}
            self._layout = layout
        sc = self.scratch
        sc["pos"].copy_(cache["pos"])
        for pn, layer in cache["stack"].items():
            for key, t in layer.items():
                sc["stack"][pn][key].copy_(t[:dd])
        return sc

    def __call__(self, params, cache, tok0, active, keys, temperature: float,
                 step, pages=None):
        cfg = self.cfg
        sc = self.load_scratch(cache)
        kd = sampling.fold_in(sampling.fold_step(keys, step), _STREAM_DRAFT)
        tok, toks, lgs = tok0, [], []
        for j in range(self.k):
            logits, _ = decode_step(params, sc, tok, cfg,
                                    depth=self.draft_depth, active=active,
                                    pages=pages, page_size=self.page_size,
                                    plan_len=self.plan_len, fused=self.fused)
            lg = logits[:, 0]
            nxt = sampling.sample_tokens(lg, sampling.fold_in(kd, j),
                                         temperature, cfg.vocab_size,
                                         self.top_k)
            tok = nxt[:, None]
            toks.append(nxt)
            lgs.append(lg)
        return torch.stack(toks, dim=1), torch.stack(lgs, dim=1)


def make_draft_step(cfg: ModelConfig, draft_depth: int, k: int,
                    top_k: int = 0, page_size: int = 0, plan_len: int = 0,
                    fused: bool = False) -> DraftStep:
    """The K-token drafting function for one (draft_depth, K); with
    ``page_size`` > 0 it takes a trailing page-table operand."""
    return DraftStep(cfg, draft_depth, k, top_k, page_size, plan_len, fused)


def make_verify_step(cfg: ModelConfig, depth: int, k: int, top_k: int = 0,
                     page_size: int = 0, plan_len: int = 0,
                     fused: bool = False):
    """The verify + accept + commit function for one (depth, K):
    ``verify(params, cache, tokens (B, K+1), draft_logits, active, keys,
    temperature, step[, pages]) -> (out_tokens (B, K+1), n_accepted (B,),
    cache)``, with ``cache`` committed in place. With ``page_size`` > 0 a
    trailing page table routes both the verify's reads and the commit's
    writes; the host frees the tail pages speculation reached past the
    commit."""

    def verify(params, cache, tokens, draft_logits, active, keys,
               temperature: float, step, pages=None):
        logits, pending = verify_step(params, cache, tokens, cfg,
                                      depth=depth, active=active,
                                      pages=pages, page_size=page_size,
                                      plan_len=plan_len, fused=fused)
        out, n_acc = accept_speculative(
            logits, draft_logits, tokens, sampling.fold_step(keys, step),
            temperature, cfg.vocab_size, top_k)
        return out, n_acc, commit_verify(cache, pending, n_acc, cfg,
                                         pages=pages, page_size=page_size)

    return verify


# ---------------------------------------------------------------------------
# acceptance telemetry (feeds SLOPolicy's K choice)
# ---------------------------------------------------------------------------


@dataclass
class SpecTelemetry:
    """Online acceptance statistics for one (depth, draft_depth, K) path."""

    k: int
    launches: int = 0
    slot_launches: int = 0  # sum of active slots over launches
    drafted: int = 0
    accepted: int = 0
    emitted: int = 0  # accepted + the per-slot replacement/bonus token
    total_s: float = 0.0  # draft + verify wall time (never decode-step time)

    def record(self, n_accepted, n_slots: int, dt_s: float = 0.0) -> None:
        self.launches += 1
        self.slot_launches += n_slots
        self.drafted += self.k * n_slots
        acc = int(sum(n_accepted))
        self.accepted += acc
        self.emitted += acc + n_slots
        self.total_s += dt_s

    @property
    def accept_rate(self) -> float:
        """Accepted fraction of drafted tokens."""
        return self.accepted / self.drafted if self.drafted else 0.0

    @property
    def accepted_per_launch(self) -> float:
        return self.accepted / self.launches if self.launches else 0.0

    @property
    def tokens_per_launch(self) -> float:
        """Generated tokens per verify launch, summed over batch slots."""
        return self.emitted / self.launches if self.launches else 0.0

    @property
    def tokens_per_slot_launch(self) -> float:
        """Generated tokens per (slot, verify launch)."""
        return self.emitted / self.slot_launches if self.slot_launches else 0.0

    def summary(self) -> Dict[str, float]:
        return {"k": self.k, "launches": self.launches,
                "accept_rate": round(self.accept_rate, 4),
                "accepted_per_launch": round(self.accepted_per_launch, 3),
                "tokens_per_launch": round(self.tokens_per_launch, 3),
                "tokens_per_slot_launch":
                    round(self.tokens_per_slot_launch, 3),
                "tokens_per_s": round(self.emitted / self.total_s, 1)
                if self.total_s > 0 else 0.0}

    def metric_values(self, prefix: str) -> Dict[str, float]:
        """Flat ``{name: value}`` gauges for a MetricsRegistry callback."""
        return {
            f"{prefix}_launches": float(self.launches),
            f"{prefix}_accept_rate": self.accept_rate,
            f"{prefix}_accepted_per_launch": self.accepted_per_launch,
            f"{prefix}_tokens_per_launch": self.tokens_per_launch,
            f"{prefix}_tokens_per_slot_launch": self.tokens_per_slot_launch,
        }


def expected_tokens_per_launch(accept_rate: float, k: int) -> float:
    """E[tokens per verify launch] under i.i.d. acceptance ``a``:
    1 + a + ... + a^k."""
    a = min(max(accept_rate, 0.0), 1.0)
    if a >= 1.0:
        return float(k + 1)
    return (1.0 - a ** (k + 1)) / (1.0 - a)


def per_candidate_accept_rate(depth_fraction: float,
                              branching: Optional[Tuple[int, ...]] = None
                              ) -> float:
    """Per-candidate acceptance rate from a measured accepted-depth
    fraction: for a linear launch (mean n_accepted / K) it is the fraction
    itself. A tree's per-level survival is inverted at its branching in the
    tree slice."""
    if branching:
        raise NotImplementedError(_TREE_SLICE)
    return min(max(depth_fraction, 0.0), 1.0)
