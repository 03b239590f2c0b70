"""The collectives of tensor-parallel serving, and the shard context that
turns them on.

The model code calls ``reduce_partial``, ``embed_lookup``,
``gather_vocab`` and ``norm_sum`` at the sites where the JAX package
constrains a sharding (``repro.models.layers`` and ``repro.models.model``).
Outside a ``shard_context`` they are the identity (or the plain lookup),
so the single-device path runs as before. Inside one, on a rank of a
(data, model) mesh:

* ``reduce_partial``: the output of a row-parallel projection (attention
  ``wo``, the MLP's ``wo``, the SSM ``out_proj``) is this rank's partial
  sum; it is all-reduced over ``model``. The partials arrive in the
  activation dtype (the ``morph_matmul`` and fused kernels write their
  output in it), so each is rounded once there; the sum runs in f32 and is
  cast back once.
* ``embed_lookup``: the vocab-sharded embedding: a masked lookup of the
  rows this rank holds plus an all-reduce (one non-zero term: exact).
* ``gather_vocab``: local logits all-gathered over ``model`` into the
  replicated logits the host's argmax and sampling read.
* ``norm_sum``: the gated SSM norm's sum of squares and active channel
  count, all-reduced before the scale.
* ``expert_range``: the MoE experts this rank holds (all of them where it
  holds a column slice of each); their gated sum is a partial sum for
  ``reduce_partial``.

``MeshStep`` wraps a step callable for one rank: it cuts the per-slot
operands to the rank's slots (when slots split over ``data``), turns the
global prefix widths into local ones (``localize``), runs the step inside
the context and all-gathers its per-slot outputs over ``data``. Under ``serve_2d`` it hands
the step a view of the parameters (``Serve2D.view``) that gathers a layer
group's data-split dims over ``data`` when the model code first indexes
that group. ``route`` runs a thread's ``MeshStep`` calls on another
``ShardComm`` over process groups of its own (the autoscaler's builder,
whose warm runs must not interleave with the serving thread's
collectives).

Over gloo with CUDA tensors (ranks sharing one card) each collective stages
through host memory.
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Dict, List, Optional

import torch
import torch.distributed as dist

from repro_torch.parallel.sharding import (_ACTIVE_KEYS, ServeShard,
                                           Serve2DLeaf, _at)
from repro_torch.parallel.sharding import _map_with_path as _walk

_CTX = threading.local()


class ShardComm:
    """A rank's shard plan plus the process groups of its mesh axes."""

    def __init__(self, shard: ServeShard, model_group=None, data_group=None,
                 stage: bool = False, serve2d: Optional["Serve2D"] = None):
        self.shard = shard
        self.model_group = model_group
        self.data_group = data_group
        self.stage = stage  # gloo over CUDA tensors: go through the host
        self.serve2d = serve2d  # serve_2d's held weights, else None

    def over(self, model_group, data_group) -> "ShardComm":
        """The same shard over other process groups (``serve_2d``'s
        gathers with buffers of their own)."""
        return ShardComm(self.shard, model_group, data_group, self.stage,
                         None if self.serve2d is None
                         else self.serve2d.over(data_group))


@contextlib.contextmanager
def shard_context(comm: Optional[ShardComm]):
    prev = getattr(_CTX, "val", None)
    _CTX.val = comm
    try:
        yield
    finally:
        _CTX.val = prev


def current() -> Optional[ShardComm]:
    return getattr(_CTX, "val", None)


@contextlib.contextmanager
def route(comm: Optional[ShardComm]):
    """Run this thread's ``MeshStep`` calls on ``comm`` (None: each step's
    own)."""
    prev = getattr(_CTX, "route", None)
    _CTX.route = comm
    try:
        yield
    finally:
        _CTX.route = prev


def _model(comm: Optional[ShardComm]) -> bool:
    return comm is not None and comm.shard.tp > 1


def model_sharded() -> bool:
    """True inside a shard context whose model axis has more than one
    rank."""
    return _model(current())


def _all_reduce(t: torch.Tensor, group, stage: bool,
                op=dist.ReduceOp.SUM) -> torch.Tensor:
    if stage and t.is_cuda:
        h = t.cpu()
        dist.all_reduce(h, op=op, group=group)
        t.copy_(h)
    else:
        dist.all_reduce(t, op=op, group=group)
    return t


def _all_gather(t: torch.Tensor, group, n: int, stage: bool,
                dim: int) -> torch.Tensor:
    src = t.cpu() if stage and t.is_cuda else t.contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim).to(t.device)


def reduce_partial(x: torch.Tensor) -> torch.Tensor:
    """Sum a row-parallel projection's partial outputs over ``model``."""
    comm = current()
    if not _model(comm):
        return x
    y = x.float() if x.dtype != torch.float32 else x.clone()
    return _all_reduce(y, comm.model_group, comm.stage).to(x.dtype)


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]`` over a vocab-sharded ``table``."""
    comm = current()
    if not _model(comm):
        return table[tokens]
    v0, n = comm.shard.vocab
    local = tokens.long() - v0
    hit = (local >= 0) & (local < n)
    rows = table[local.clamp(0, n - 1)].float()
    rows = torch.where(hit[..., None], rows, torch.zeros((), device=rows.device))
    return _all_reduce(rows, comm.model_group, comm.stage).to(table.dtype)


def gather_vocab(logits: torch.Tensor) -> torch.Tensor:
    """Local vocab-slice logits -> replicated full logits (last dim)."""
    comm = current()
    if not _model(comm):
        return logits
    return _all_gather(logits, comm.model_group, comm.shard.tp, comm.stage,
                       dim=-1)


def norm_sum(sumsq: torch.Tensor, count: torch.Tensor):
    """All-reduce a sharded norm's f32 sum of squares (..., 1) and its
    channel count (broadcastable to it) over ``model``; returns both."""
    comm = current()
    if not _model(comm):
        return sumsq, count
    count = torch.broadcast_to(count.float(), sumsq.shape)
    both = _all_reduce(torch.cat([sumsq, count], dim=-1), comm.model_group,
                       comm.stage)
    return both[..., :1], both[..., 1:]


def expert_range(n_experts: int):
    """(start, size) of the MoE experts this rank holds: all of them
    outside a model-sharded context and where the rank holds a column
    slice of every expert."""
    comm = current()
    if not _model(comm) or not comm.shard.experts[1]:
        return 0, n_experts
    return comm.shard.experts


def gather_tree(tree, specs, mesh):
    """The full tensors of a sharded pytree: every leaf all-gathered over
    the mesh axes its spec splits it on (a tuple of axes innermost first),
    the inverse of ``sharding.shard_params`` over the ranks of ``mesh``."""
    stage = dist.get_backend() == "gloo"

    def leaf(t, spec):
        for dim, ax in enumerate(spec):
            if ax is None:
                continue
            for a in reversed((ax,) if isinstance(ax, str) else tuple(ax)):
                n = mesh.size(mesh.mesh_dim_names.index(a))
                if n > 1:
                    t = _all_gather(t, mesh.get_group(a), n, stage, dim)
        return t

    def walk(t, sp):
        if isinstance(t, dict):
            return {k: walk(v, sp[k]) for k, v in t.items()}
        return leaf(t, sp)

    return walk(tree, specs)


# ---------------------------------------------------------------------------
# serve_2d: weights split over data too, gathered a layer group at a time
# ---------------------------------------------------------------------------


class _GatherSet:
    """The leaves gathered together: one all-gather over ``data`` per
    dtype into a send / receive buffer pair (staged through pinned host
    buffers under gloo with CUDA tensors), then each leaf assembled into
    a buffer of its own. Every buffer is allocated at the first gather and
    reused by every later one (each group of a stack, each step)."""

    def __init__(self, owner: "Serve2D", paths: List[tuple],
                 grouped: bool):
        self.owner, self.paths, self.grouped = owner, paths, grouped
        self._bufs: Dict[Any, Any] = {}

    def _buf(self, key, shape, like, host: bool = False):
        b = self._bufs.get(key)
        if b is None or tuple(b.shape) != tuple(shape):
            b = (torch.empty(shape, dtype=like.dtype, pin_memory=True)
                 if host else
                 torch.empty(shape, dtype=like.dtype, device=like.device))
            self._bufs[key] = b
        return b

    def gather(self, held, g: Optional[int]):
        """{path: the serve_tp piece} of group ``g`` (None: whole leaves)."""
        own = self.owner
        pieces = {p: (_at(held, p)[g] if self.grouped else _at(held, p))
                  for p in self.paths}
        lead = 1 if self.grouped else 0
        out = {}
        split = [p for p in self.paths
                 if own.recipes[p].data_dim is not None and own.dp > 1]
        t0 = time.perf_counter()
        by_dtype: Dict[Any, List[tuple]] = {}
        for p in split:
            by_dtype.setdefault(pieces[p].dtype, []).append(p)
        for dt, paths in by_dtype.items():
            n = sum(pieces[p].numel() for p in paths)
            x0 = pieces[paths[0]]
            send = self._buf(("send", dt), (n,), x0)
            off = 0
            for p in paths:
                k = pieces[p].numel()
                send[off:off + k].copy_(pieces[p].reshape(-1))
                off += k
            recv = self._buf(("recv", dt), (own.dp, n), x0)
            if own.stage and send.is_cuda:  # gloo: through pinned host memory
                hsend = self._buf(("hsend", dt), (n,), x0, host=True)
                hrecv = self._buf(("hrecv", dt), (own.dp, n), x0, host=True)
                hsend.copy_(send)
                dist.all_gather(list(hrecv.unbind(0)), hsend,
                                group=own.data_group)
                recv.copy_(hrecv, non_blocking=True)
            else:
                dist.all_gather(list(recv.unbind(0)), send,
                                group=own.data_group)
            off = 0
            for p in paths:
                piece, rec = pieces[p], own.recipes[p]
                k = piece.numel()
                parts = [recv[r, off:off + k].view(piece.shape)
                         for r in range(own.dp)]
                off += k
                dim = rec.data_dim - lead
                full_shape = list(piece.shape)
                full_shape[dim] *= own.dp
                full = self._buf(("full", p), full_shape, piece)
                torch.cat(parts, dim=dim, out=full)
                out[p] = self._cut(p, full, lead)
        for p in self.paths:
            if p not in out:
                out[p] = self._cut(p, pieces[p], lead)
        own.gather_s += time.perf_counter() - t0
        own.gathers += bool(split)
        return out

    def _cut(self, p, t, lead):
        after = self.owner.recipes[p].after
        if not after:
            return t
        shape = self.owner.recipes[p].shape[lead:]
        buf = self._buf(("cut", p), shape, t)
        view = t
        for dim, (start, size) in after.items():
            view = view.narrow(dim - lead, start, size)
        return buf.copy_(view)


class GroupGather:
    """A stacked parameter tree under ``serve_2d``: ``group(g)`` gathers
    group ``g``'s leaves (``models.model`` indexes a stack through it)."""

    def __init__(self, held, prefix: tuple, gset: _GatherSet, n_groups: int):
        self.held, self.prefix, self.gset = held, prefix, gset
        self.n_groups = n_groups

    def group(self, g: int):
        got = self.gset.gather(self.held, g)
        return _walk(_at(self.held, self.prefix),
                     lambda p, _t: got[self.prefix + p])

    def __getitem__(self, g: int):
        return self.group(g)

    def __iter__(self):
        return (self.group(g) for g in range(self.n_groups))


class Serve2D:
    """``serve_2d``'s parameters on one rank: the held tree (each leaf as
    ``param_specs(..., "serve_2d")`` cuts it) and, leaf for leaf, the
    ``sharding.Serve2DLeaf`` recipe of its ``serve_tp`` piece. ``view``
    gives a step the tree it runs on: the leaves outside the layer stacks
    gathered at once, each stack a ``GroupGather``. ``gather_s`` /
    ``gathers`` / ``views`` count the gathers' host seconds, the gathers
    and the step calls."""

    def __init__(self, recipes, data_group, dp: int, stage: bool):
        self.recipes_tree = recipes
        self.recipes: Dict[tuple, Serve2DLeaf] = {}
        _walk(recipes, lambda p, r: self.recipes.__setitem__(p, r))
        self.data_group, self.dp, self.stage = data_group, dp, stage
        self.gather_s, self.gathers, self.views = 0.0, 0, 0
        stacks = [p for p in (("stack",), ("encoder", "stack"))
                  if p[0] in recipes and (len(p) == 1
                                          or p[1] in recipes[p[0]])]
        self._stacks = {s: _GatherSet(self, [p for p in self.recipes
                                             if p[:len(s)] == s], True)
                        for s in stacks}
        self._top = _GatherSet(self, [p for p in self.recipes if not any(
            p[:len(s)] == s for s in stacks)], False)

    def over(self, data_group) -> "Serve2D":
        """The same recipes over another group, with buffers of its own."""
        return Serve2D(self.recipes_tree, data_group, self.dp, self.stage)

    def view(self, held):
        self.views += 1
        top = self._top.gather(held, None)
        out = _walk(held, lambda p, t: top.get(p))
        for s, gset in self._stacks.items():
            node = out
            for k in s[:-1]:
                node = node[k]
            first = next(_leaves(_at(held, s)))
            node[s[-1]] = GroupGather(held, s, gset, int(first.shape[0]))
        return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


# ---------------------------------------------------------------------------
# per-rank step wrapping
# ---------------------------------------------------------------------------


def localize(active: Dict[str, torch.Tensor], shard: ServeShard
             ) -> Dict[str, torch.Tensor]:
    """Global prefix widths -> this rank's: a shard holding columns
    ``[s, s + n)`` of a dim runs ``clamp(a - s, 0, n)`` of them (0 on a
    rank past the active prefix, which still joins the collectives)."""
    out = {}
    for k, a in active.items():
        rng = shard.ranges.get(k)
        if rng is None or shard.tp == 1:
            out[k] = a
        else:
            out[k] = torch.clamp(a - rng[0], 0, rng[1]).to(a.dtype)
    return out


def _is_active(x) -> bool:
    return isinstance(x, dict) and x and set(x) <= set(_ACTIVE_KEYS) | {
        "top_k"}


class MeshStep:
    """A step callable ``fn(params, cache, *operands)`` run as one rank's
    shard: per-slot operands (tensors whose dim 0 is ``n_slots``) cut to
    the rank's slots, width operands localized, the call made inside the
    shard context, and every per-slot tensor of the result other than the
    cache all-gathered over ``data``. ``n_lead`` leading arguments (the
    parameters and the cache) pass through; ``slots=False`` leaves every
    operand and result whole (a prompt pass, replicated over ``data``).
    The call runs on ``route``'s comm where this thread set one."""

    def __init__(self, fn, comm: ShardComm, n_lead: int = 2,
                 slots: bool = True):
        self.fn, self.comm, self.n_lead = fn, comm, n_lead
        # False: a call whose operands are not per slot (a prompt pass)
        self.split = slots and comm.shard.split_slots
        self._local: Dict[int, Any] = {}  # id(active) -> (active, local)

    def __getattr__(self, name):
        # the wrapped step's own methods (a draft step's ``release``)
        if name == "fn":
            raise AttributeError(name)
        return getattr(self.fn, name)

    def _operand(self, x, comm):
        sh = comm.shard
        if _is_active(x):
            hit = self._local.get(id(x))
            if hit is not None and hit[0] is x:
                return hit[1]
            loc = localize({k: self._operand(v, comm) for k, v in x.items()},
                           sh)
            if len(self._local) > 256:
                self._local.clear()
            self._local[id(x)] = (x, loc)
            return loc
        if (self.split and isinstance(x, torch.Tensor) and x.dim()
                and x.shape[0] == sh.n_slots):
            return x.narrow(0, sh.slots[0], sh.slots[1])
        return x

    def _output(self, y, cache, comm):
        sh = comm.shard
        if (self.split and isinstance(y, torch.Tensor) and y is not cache
                and y.dim() and y.shape[0] == sh.slots[1]):
            return _all_gather(y, comm.data_group, sh.dp, comm.stage, dim=0)
        return y

    def __call__(self, *args):
        comm = getattr(_CTX, "route", None) or self.comm
        lead = args[:self.n_lead]
        rest = [self._operand(a, comm) for a in args[self.n_lead:]]
        cache = lead[1] if len(lead) > 1 else None
        with shard_context(comm):
            if comm.serve2d is not None:  # the params: serve_2d's held tree
                lead = (comm.serve2d.view(lead[0]),) + tuple(lead[1:])
            out = self.fn(*lead, *rest)
        if isinstance(out, tuple):
            return tuple(self._output(y, cache, comm) for y in out)
        return self._output(out, cache, comm)
