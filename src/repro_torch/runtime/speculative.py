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

Token trees (``SpecConfig.trees``, SpecInfer-style static branching
schedules, ``TreeTopology``): ``make_tree_draft_step`` grows the tree level
by level at the exit depth, carrying K/V and SSM state forward
(``draft_tree_level``, each node scored once), and
``make_tree_verify_step`` scores every node in one full-depth
``verify_tree`` pass (ancestor-mask attention, per-node SSM state), picks
the accepted root-to-leaf path with ``accept_tree`` and commits it with
``commit_verify(path_nodes=)``. The committed cache is never written by a
tree draft, so a tree draft needs no scratch copy.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import (commit_verify, decode_step,
                                      draft_tree_level, init_tree_draft_carry,
                                      tree_carry_nodes, verify_step,
                                      verify_tree)
from repro_torch.runtime import sampling

# stream ids folded into the per-launch slot keys so every random use is
# disjoint: draft position j uses (DRAFT, j); acceptance uniforms ACCEPT;
# the replacement/bonus sample BONUS.
_STREAM_DRAFT = 1
_STREAM_ACCEPT = 2
_STREAM_BONUS = 3

def draft_compile_key(draft_depth: int, k: int) -> Tuple:
    return ("spec_draft", draft_depth, k)


def verify_compile_key(depth: int, k: int) -> Tuple:
    return ("spec_verify", depth, k)


def tree_draft_compile_key(draft_depth: int,
                           branching: Tuple[int, ...]) -> Tuple:
    return ("spec_tree_draft", draft_depth, branching)


def tree_verify_compile_key(depth: int, branching: Tuple[int, ...]) -> Tuple:
    return ("spec_tree_verify", depth, branching)


# ---------------------------------------------------------------------------
# token-tree topologies (static: the tree shape is part of the compile key)
# ---------------------------------------------------------------------------


class TreeTopology:
    """A static token-tree shape, flattened in BFS level order.

    ``branching[l]`` is the number of children every node at level ``l``
    gets: ``(3, 2, 1)`` is a root with 3 children, 6 grandchildren and 6
    leaves. Node 0 is the root (the last committed token); parents precede
    children, and the children of a level's j-th node are the next level's
    nodes ``j * b .. j * b + b - 1``. All arrays are host numpy constants.

    Attributes: ``n_nodes``, ``n_levels``, ``parents`` (N,) int (root -1),
    ``depths`` (N,) int, ``children`` (N, max_b) int padded with 0,
    ``paths`` (per-node root-to-node index tuples) and ``ancestor_bias``
    (N, N) f32: 0 where column j is an ancestor-or-self of row i, -1e9
    elsewhere."""

    def __init__(self, branching: Tuple[int, ...]):
        branching = tuple(int(b) for b in branching)
        if any(b < 1 for b in branching):
            raise ValueError(f"tree branching must be >= 1 per level, "
                             f"got {branching}")
        self.branching = branching
        parents, depths, frontier = [-1], [0], [0]
        for lvl, b in enumerate(branching):
            nxt = []
            for node in frontier:
                for _ in range(b):
                    nxt.append(len(parents))
                    parents.append(node)
                    depths.append(lvl + 1)
            frontier = nxt
        self.n_nodes = len(parents)
        self.n_levels = len(branching)
        self.parents = np.asarray(parents, np.int32)
        self.depths = np.asarray(depths, np.int32)
        children = np.zeros((self.n_nodes, max(branching, default=1)),
                            np.int32)
        counts = np.zeros(self.n_nodes, np.int32)
        for node, par in enumerate(parents):
            if par >= 0:
                children[par, counts[par]] = node
                counts[par] += 1
        self.children = children
        paths = []
        for node in range(self.n_nodes):
            path = [node]
            while parents[path[-1]] >= 0:
                path.append(parents[path[-1]])
            paths.append(tuple(reversed(path)))
        self.paths = tuple(paths)
        bias = np.full((self.n_nodes, self.n_nodes), -1e9, np.float32)
        for node, path in enumerate(paths):
            bias[node, list(path)] = 0.0
        self.ancestor_bias = bias

    def level_nodes(self, level: int) -> Tuple[int, int]:
        """[start, stop) node range of ``level`` (contiguous in BFS order)."""
        idx = np.nonzero(self.depths == level)[0]
        return int(idx[0]), int(idx[-1]) + 1

    @property
    def n_draft_nodes(self) -> int:
        """Candidate tokens drafted per launch (the root excluded)."""
        return self.n_nodes - 1


@lru_cache(maxsize=None)
def tree_topology(branching: Tuple[int, ...]) -> TreeTopology:
    """Memoized topology: every (depth, tree) step of one schedule shares
    the same arrays."""
    return TreeTopology(branching)


@dataclass(frozen=True)
class SpecConfig:
    """Speculative serving configuration (engine-level policy knobs).

    ``ks`` is the linear draft-length table and ``trees`` the token-tree
    table (branching schedules): one draft step per (draft_depth, shape)
    and one verify step per (depth, shape) are built at warmup, and the SLO
    policy may switch between them (and plain stepping) at runtime without
    building anything. ``draft_depth`` pins the drafting exit; None picks
    the deepest exit shallower than each serving depth. When the mean
    per-candidate acceptance over a ``window``-launch rolling window falls
    below ``min_accept_rate``, the group falls back to plain stepping for
    ``cooloff_ticks`` ticks."""

    ks: Tuple[int, ...] = (4,)
    trees: Tuple[Tuple[int, ...], ...] = ()
    draft_depth: Optional[int] = None
    min_accept_rate: float = 0.05
    window: int = 32
    cooloff_ticks: int = 200
    top_k: int = 0


@dataclass(frozen=True)
class SpecPlanEntry:
    """Resolved speculative wiring for one serving depth."""

    depth: int
    draft_depth: int
    ks: Tuple[int, ...]
    trees: Tuple[Tuple[int, ...], ...] = ()


def spec_plan(depths, spec: SpecConfig) -> Dict[int, SpecPlanEntry]:
    """Resolve (serving depth -> draft depth, K and tree tables) over the
    mode table. Only depths with a strictly shallower depth can speculate
    (the shallowest keeps plain stepping); an explicit ``spec.draft_depth``
    is honoured wherever it is shallower than the serving depth."""
    if not spec.ks and not spec.trees:
        raise ValueError("SpecConfig needs at least one draft shape: a "
                         "linear K in `ks` or a tree schedule in `trees`")
    trees = tuple(sorted({tuple(int(b) for b in br) for br in spec.trees}))
    for br in trees:
        tree_topology(br)  # validates branching >= 1 per level
    depths = sorted(set(depths))
    plan: Dict[int, SpecPlanEntry] = {}
    for d in depths:
        cands = [e for e in depths if e < d]
        if spec.draft_depth is not None:
            cands = [e for e in cands if e == spec.draft_depth]
        if cands:
            plan[d] = SpecPlanEntry(depth=d, draft_depth=max(cands),
                                    ks=tuple(sorted(set(spec.ks))),
                                    trees=trees)
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


def accept_tree(logits, draft_logits, tokens, topo: TreeTopology, keys,
                temperature: float, vocab: int, top_k: int = 0):
    """Token-tree rejection sampling: pick the accepted root-to-leaf path.

    logits: (B, N, Vp) verifier scores over the flattened tree (row j = the
    next-token distribution after the root-to-j path); draft_logits:
    (B, N, Vp) the draft distribution AT each node, the one its children
    were sampled from (leaf rows unused); tokens: (B, N) the tree's tokens
    (node 0 = the last committed token); keys: (B,) per-launch slot keys.

    One multi-candidate rejection round per level: children are tried in
    sibling order, child ``x_i`` is accepted with prob ``min(1, res_i(x_i)
    / q(x_i))`` (division-free), ``res_1`` the verifier distribution at the
    current node and ``res_{i+1} = normalize(max(res_i - q, 0))`` after each
    rejection; distribution-identical to sampling the verifier token by
    token when siblings are i.i.d. draws from ``q``. At temperature 0 the
    one-hot distributions reduce it to greedy descent: into the child equal
    to the verifier's argmax, at any sibling rank, stopping when none is.

    Returns (out_tokens (B, L), path_nodes (B, L), n_accepted (B,)) with
    L = n_levels + 1: ``out_tokens[:, :n+1]`` is the generated stream,
    ``path_nodes`` the accepted path's node indices (entry 0 the root,
    entries past ``n_accepted`` repeat the stop node), all on the device."""
    B, N = tokens.shape
    dev = logits.device
    p = sampling.token_dist(logits, temperature, vocab, top_k)  # (B, N, V)
    q = sampling.token_dist(draft_logits, temperature, vocab, top_k)
    u = sampling.uniform(sampling.fold_in(keys, _STREAM_ACCEPT), N)  # (B, N)
    children = torch.as_tensor(topo.children, device=dev).long()
    toks = tokens.long()
    rows = torch.arange(B, device=dev)
    cur = torch.zeros((B,), dtype=torch.int64, device=dev)
    n_acc = torch.zeros((B,), dtype=torch.int64, device=dev)
    alive = torch.ones((B,), dtype=torch.bool, device=dev)
    final_res = p[:, 0]  # replacement / bonus distribution at the stop node
    acc_toks, path_rows = [], [cur]
    for b in topo.branching:
        qcur = q[rows, cur]
        res = p[rows, cur]
        chosen = torch.full((B,), -1, dtype=torch.int64, device=dev)
        for i in range(b):
            ci = children[cur, i]
            xi = toks[rows, ci]
            not_yet = alive & (chosen < 0)
            # q(x_i) may be 0 (top-k, or a sibling past rank 0 at
            # temperature 0): then accept iff res(x_i) > 0
            acc_i = not_yet & (u[rows, ci] * qcur[rows, xi] < res[rows, xi])
            chosen = torch.where(acc_i, ci, chosen)
            sub = torch.clamp(res - qcur, min=0.0)
            rs = sub.sum(-1, keepdim=True)
            res = torch.where((not_yet & ~acc_i)[:, None],
                              sub / torch.clamp(rs, min=1e-38), res)
        accepted = alive & (chosen >= 0)
        final_res = torch.where((alive & ~accepted)[:, None], res, final_res)
        acc_toks.append(toks[rows, chosen.clamp(min=0)])  # masked below
        cur = torch.where(accepted, chosen, cur)
        path_rows.append(cur)
        n_acc = n_acc + accepted.long()
        alive = accepted
    p_stop = p[rows, cur]
    final_res = torch.where(alive[:, None], p_stop, final_res)  # leaf: bonus
    final_res = torch.where(final_res.sum(-1, keepdim=True) > 0, final_res,
                            p_stop)  # a degenerate residual
    if temperature > 0:
        last = sampling.categorical(sampling.fold_in(keys, _STREAM_BONUS),
                                    final_res)
    else:
        last = final_res.argmax(-1)
    j = torch.arange(topo.n_levels + 1, device=dev)[None, :]
    acc_pad = torch.stack(acc_toks + [torch.zeros_like(cur)], dim=1)
    out = torch.where(j < n_acc[:, None], acc_pad, last[:, None])
    return out, torch.stack(path_rows, dim=1), n_acc


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

    def release(self) -> None:
        """Drop the scratch, so the next call allocates its own on the
        caller's stream (a step warmed on another thread's stream must not
        hand its memory over)."""
        self.scratch, self._layout = None, None

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


def tree_draft_position_count(branching: Tuple[int, ...]) -> int:
    """Positions the KV-carrying tree draft processes per launch: each
    node once, the last level's excepted (leaf logits feed no child)."""
    return tree_carry_nodes(tree_topology(tuple(branching)))


def tree_rescore_position_count(branching: Tuple[int, ...]) -> int:
    """Positions a level-rescoring draft would touch per launch (the whole
    tree prefix again at every level): the baseline the carry is held to."""
    topo = tree_topology(tuple(branching))
    return sum(tree_topology(topo.branching[:level]).n_nodes
               for level in range(topo.n_levels))


class TreeDraftStep:
    """Token-tree drafting at one exit depth, level by level.

    ``draft(params, cache, tok0, active, keys, temperature, step[, pages])
    -> (tree_tokens (B, N), draft_logits (B, N, Vp) f32)`` with node 0 =
    ``tok0``. Each level runs one ``draft_tree_level`` pass over its
    frontier only, against the committed cache (read, never written) plus
    the K/V and SSM state carried from earlier levels, so a launch touches
    each node once (``tree_draft_position_count``). A level's children come
    from its frontier's exit-head logits in one batched call: at
    temperature 0 the top-b tokens (one ``topk`` over the frontier), above
    it i.i.d. draws from the draft distribution, child c drawing with the
    draft key folded with c, so siblings draw independent streams (what the
    multi-candidate acceptance rule needs). Leaf rows of ``draft_logits``
    are zero.

    The carry (``init_tree_draft_carry``) is allocated at the first call
    and reused: every row a level reads was written by an earlier level of
    the same call. The level passes take the einsum attention path in fused
    engines too, as the reference's draft does (its carry geometry is not a
    fused-kernel shape); only the tree verify reaches the fused kernel."""

    def __init__(self, cfg: ModelConfig, draft_depth: int,
                 branching: Tuple[int, ...], top_k: int = 0,
                 page_size: int = 0):
        self.cfg, self.draft_depth, self.top_k = cfg, draft_depth, top_k
        self.topo = tree_topology(tuple(branching))
        self.page_size = page_size
        self.carry: Optional[Dict] = None
        self._layout = None  # (batch, device) the carry was made for

    def release(self) -> None:
        """Drop the carry, so the next call allocates its own on the
        caller's stream (as ``DraftStep.release``)."""
        self.carry, self._layout = None, None

    def __call__(self, params, cache, tok0, active, keys, temperature: float,
                 step, pages=None):
        cfg, topo = self.cfg, self.topo
        B, dev = tok0.shape[0], tok0.device
        vocab = cfg.vocab_size
        if self._layout != (B, str(dev)):
            self.carry = init_tree_draft_carry(cfg, B, topo,
                                               depth=self.draft_depth,
                                               device=dev)
            self._layout = (B, str(dev))
        kd = sampling.fold_in(sampling.fold_step(keys, step), _STREAM_DRAFT)
        tokens = torch.zeros((B, topo.n_nodes), dtype=torch.int64,
                             device=dev)
        tokens[:, 0] = tok0[:, 0]
        dlg = torch.zeros((B, topo.n_nodes, cfg.padded_vocab()),
                          dtype=torch.float32, device=dev)
        for level, b in enumerate(topo.branching):
            f0, f1 = topo.level_nodes(level)
            nf = f1 - f0
            lg, _ = draft_tree_level(params, cache, self.carry,
                                     tokens[:, f0:f1], cfg, tree=topo,
                                     level=level, depth=self.draft_depth,
                                     active=active, pages=pages,
                                     page_size=self.page_size)
            dlg[:, f0:f1] = lg.float()
            # the children of the level's j-th node are f1 + j * b + i
            if temperature > 0:
                probs = sampling.token_dist(lg, temperature, vocab,
                                            self.top_k)
                probs = probs.repeat_interleave(b, dim=1)
                ck = sampling.fold_in(kd[:, None], torch.arange(
                    f1, f1 + nf * b, device=dev)[None, :])
                kids = sampling.categorical(ck.reshape(-1),
                                            probs.reshape(B * nf * b, -1))
            else:
                lg_m = sampling.top_k_mask(lg[..., :vocab].float(),
                                           self.top_k)
                kids = torch.topk(lg_m, b, dim=-1).indices
            tokens[:, f1:f1 + nf * b] = kids.reshape(B, nf * b)
        return tokens, dlg


def make_tree_draft_step(cfg: ModelConfig, draft_depth: int,
                         branching: Tuple[int, ...], top_k: int = 0,
                         page_size: int = 0) -> TreeDraftStep:
    """The token-tree drafting function for one (draft_depth, tree); with
    ``page_size`` > 0 it takes a trailing page-table operand."""
    return TreeDraftStep(cfg, draft_depth, branching, top_k, page_size)


def make_tree_verify_step(cfg: ModelConfig, depth: int,
                          branching: Tuple[int, ...], top_k: int = 0,
                          page_size: int = 0, plan_len: int = 0,
                          fused: bool = False):
    """The tree verify + accept + commit function for one (depth, tree):
    ``verify(params, cache, tree_tokens (B, N), draft_logits, active, keys,
    temperature, step[, pages]) -> (out_tokens (B, L), n_accepted (B,),
    cache)`` with L = n_levels + 1. One ``verify_tree`` pass scores every
    node (the fused engine's attention layers through the ``fused_verify``
    kernel with the tree's depths and ancestor mask), ``accept_tree`` picks
    the path and ``commit_verify(path_nodes=)`` commits it in place."""
    topo = tree_topology(tuple(branching))

    def verify(params, cache, tokens, draft_logits, active, keys,
               temperature: float, step, pages=None):
        logits, pending = verify_tree(params, cache, tokens, cfg, tree=topo,
                                      depth=depth, active=active,
                                      pages=pages, page_size=page_size,
                                      plan_len=plan_len, fused=fused)
        out, path, n_acc = accept_tree(
            logits, draft_logits, tokens, topo,
            sampling.fold_step(keys, step), temperature, cfg.vocab_size,
            top_k)
        return out, n_acc, commit_verify(cache, pending, n_acc, cfg,
                                         path_nodes=path, pages=pages,
                                         page_size=page_size)

    return verify


# ---------------------------------------------------------------------------
# acceptance telemetry (feeds SLOPolicy's draft-shape choice)
# ---------------------------------------------------------------------------


@dataclass
class SpecTelemetry:
    """Online acceptance statistics for one (depth, draft_depth, draft
    shape) path. ``k`` is the most drafts one launch can accept (the linear
    K, or a tree's level count); ``tree`` is the branching schedule of a
    tree path and ``nodes`` the candidate nodes it drafts per slot."""

    k: int
    tree: Optional[Tuple[int, ...]] = None
    nodes: int = 0  # drafted candidate nodes per slot-launch (0: == k)
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
        out = {"k": self.k, "launches": self.launches,
               "accept_rate": round(self.accept_rate, 4),
               "accepted_per_launch": round(self.accepted_per_launch, 3),
               "tokens_per_launch": round(self.tokens_per_launch, 3),
               "tokens_per_slot_launch":
                   round(self.tokens_per_slot_launch, 3),
               "tokens_per_s": round(self.emitted / self.total_s, 1)
               if self.total_s > 0 else 0.0}
        if self.tree is not None:
            out["tree"] = "x".join(str(b) for b in self.tree)
            out["draft_nodes"] = self.nodes
        return out

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


def expected_tokens_per_tree_launch(accept_rate: float,
                                    branching: Tuple[int, ...]) -> float:
    """E[tokens per verify launch] of a token tree under i.i.d. per-node
    acceptance ``a``: a level of b sibling candidates survives with prob
    ``1 - (1 - a)^b``, so E = 1 + sum_l prod_{i<=l} (1 - (1 - a)^{b_i});
    ``expected_tokens_per_launch`` at b = 1 per level."""
    a = min(max(accept_rate, 0.0), 1.0)
    e, reach = 1.0, 1.0
    for b in branching:
        reach *= 1.0 - (1.0 - a) ** b
        e += reach
    return e


def tree_node_budget(branching: Tuple[int, ...]) -> int:
    """Candidate nodes a tree drafts per launch (matched against linear K
    when comparing tokens per verify launch)."""
    return tree_topology(tuple(branching)).n_draft_nodes


def per_candidate_accept_rate(depth_fraction: float,
                              branching: Optional[Tuple[int, ...]] = None
                              ) -> float:
    """The per-candidate acceptance rate ``a`` from a measured accepted-depth
    fraction. For a linear launch (mean n_accepted / K) it is the fraction
    itself. A tree launch's fraction measures per-level survival
    ``s = 1 - (1 - a)^b`` with b sibling candidates a level; inverting it at
    the mean branching recovers ``a``, so trees and linear K feed the
    policy (and the collapse threshold) one comparable number."""
    s = min(max(depth_fraction, 0.0), 1.0)
    if not branching:
        return s
    b = sum(branching) / len(branching)
    if b <= 1.0 or s >= 1.0:
        return s
    return 1.0 - (1.0 - s) ** (1.0 / b)
