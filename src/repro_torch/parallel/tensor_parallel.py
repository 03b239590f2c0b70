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

Training (``launch.steps.make_train_step(grad_shardings=...)``) runs the
same sites under a comm with ``train=True``, each collective an
``autograd.Function`` (Megatron's ``f`` and ``g``) working on copies, never
on a tensor autograd has saved:

* ``reduce_partial`` (``g``): all-reduce forward, identity backward;
* ``col_input`` (``f``, after every norm that feeds a column-parallel
  projection): identity forward, all-reduce over ``model`` backward, so
  the norm's gradient sees every rank's share;
* ``embed_lookup``: the all-reduce as ``g``; the masked lookup's backward
  writes this rank's rows only;
* ``gather_vocab``: the backward keeps this rank's slice; ``norm_sum``:
  all-reduce both ways;
* ``train_aux_means``: the MoE load-balancing loss over a data split
  batch (first-choice fractions averaged over ``data``) with its
  gradient counted once over ``model``;
* ``train_view``: the FSDP gather of a layer group's data-split pieces
  over ``data`` (one all-gather a dtype), its backward a reduce-scatter
  in the gradient dtype;
* with ``sp`` (sequence parallelism) ``reduce_partial`` reduce-scatters
  along the sequence, ``col_input`` all-gathers it (reduce-scatter
  backward) and ``seq_scatter`` cuts the embedded sequence.

Over gloo with CUDA tensors (ranks sharing one card) each collective stages
through host memory.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
import time
from typing import Any, Dict, List, Optional

import torch
import torch.distributed as dist

from repro_torch.parallel import collectives as C
from repro_torch.parallel.sharding import (_ACTIVE_KEYS, ServeShard,
                                           Serve2DLeaf, Sharding, _at)
from repro_torch.parallel.sharding import _map_with_path as _walk

_CTX = threading.local()


class ShardComm:
    """A rank's shard plan plus the process groups of its mesh axes."""

    def __init__(self, shard: ServeShard, model_group=None, data_group=None,
                 stage: bool = False, serve2d: Optional["Serve2D"] = None,
                 train: bool = False, sp: bool = False,
                 grad_dtype: torch.dtype = torch.float32):
        self.shard = shard
        self.model_group = model_group
        self.data_group = data_group
        self.stage = stage  # gloo over CUDA tensors: go through the host
        self.serve2d = serve2d  # serve_2d's held weights, else None
        self.train = train  # collectives with a backward (training)
        self.sp = sp and train and shard.tp > 1  # sequence parallelism
        self.grad_dtype = grad_dtype
        self.nccl = (model_group is not None or data_group is not None) \
            and C.backend() == "nccl"

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


# host seconds and calls of the collectives staged through host memory
# (gloo over CUDA tensors): ``staged_seconds`` reads, ``reset_staged`` zeroes
_STAGED = {"s": 0.0, "n": 0}


def staged_seconds() -> Dict[str, float]:
    return dict(_STAGED)


def reset_staged() -> None:
    _STAGED.update(s=0.0, n=0)


def _all_reduce(t: torch.Tensor, group, stage: bool,
                op=dist.ReduceOp.SUM) -> torch.Tensor:
    if stage and t.is_cuda:
        t0 = time.perf_counter()
        h = t.cpu()
        C.all_reduce(h, op=op, group=group)
        t.copy_(h)
        _STAGED["s"] += time.perf_counter() - t0
        _STAGED["n"] += 1
    else:
        C.all_reduce(t, op=op, group=group)
    return t


def _all_gather(t: torch.Tensor, group, n: int, stage: bool,
                dim: int) -> torch.Tensor:
    staged = stage and t.is_cuda
    t0 = time.perf_counter()
    src = t.cpu() if staged else t.contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    C.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim=dim).to(t.device)
    if staged:
        _STAGED["s"] += time.perf_counter() - t0
        _STAGED["n"] += 1
    return out


def _sum_f32(x: torch.Tensor, group, stage: bool) -> torch.Tensor:
    """``x`` summed over ``group`` in f32 (on a copy), cast back once."""
    y = x.float() if x.dtype != torch.float32 else x.clone()
    return _all_reduce(y, group, stage).to(x.dtype)


def _reduce_scatter(x: torch.Tensor, group, n: int, idx: int, stage: bool,
                    nccl: bool, dim: int) -> torch.Tensor:
    """Rank ``idx``'s 1/n slice along ``dim`` of ``x`` summed over
    ``group`` (in ``x``'s dtype; gloo has no reduce-scatter of its own,
    so there it is an all-reduce and a slice)."""
    if nccl:
        src = x.movedim(dim, 0).contiguous()
        out = src.new_empty((src.shape[0] // n,) + tuple(src.shape[1:]))
        C.reduce_scatter_tensor(out, src, group=group)
        return out.movedim(0, dim)
    y = _all_reduce(x.clone(), group, stage)
    k = x.shape[dim] // n
    return y.narrow(dim, idx * k, k).contiguous()


class _SumForward(torch.autograd.Function):
    """``g``: the f32 sum over ``model`` forward, identity backward."""

    @staticmethod
    def forward(ctx, x, comm):
        return _sum_f32(x, comm.model_group, comm.stage)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumBackward(torch.autograd.Function):
    """``f``: identity forward, the f32 sum over ``model`` backward."""

    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum_f32(g, ctx.comm.model_group, ctx.comm.stage), None


class _SumBoth(torch.autograd.Function):
    """The f32 sum over ``model`` both ways (``norm_sum``'s sum of
    squares: every rank's normed channels read the total)."""

    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return _sum_f32(x, comm.model_group, comm.stage)

    @staticmethod
    def backward(ctx, g):
        return _sum_f32(g, ctx.comm.model_group, ctx.comm.stage), None


class _SeqGather(torch.autograd.Function):
    """SP's ``f``: all-gather the sequence (dim 1) over ``model``; the
    backward sums the ranks' partial gradients in f32 and keeps this
    rank's sequence slice."""

    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return _all_gather(x, comm.model_group, comm.shard.tp, comm.stage,
                           dim=1)

    @staticmethod
    def backward(ctx, g):
        c = ctx.comm
        y = _reduce_scatter(g.float(), c.model_group, c.shard.tp,
                            c.shard.model_rank, c.stage, c.nccl, dim=1)
        return y.to(g.dtype), None


class _SeqReduceScatter(torch.autograd.Function):
    """SP's ``g``: the partial outputs summed in f32 over ``model``, this
    rank's sequence slice kept; the backward all-gathers the sequence."""

    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        y = _reduce_scatter(x.float(), comm.model_group, comm.shard.tp,
                            comm.shard.model_rank, comm.stage, comm.nccl,
                            dim=1)
        return y.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        c = ctx.comm
        return _all_gather(g, c.model_group, c.shard.tp, c.stage, dim=1), None


class _SeqSlice(torch.autograd.Function):
    """This rank's sequence slice of a replicated (B, S, d); the backward
    all-gathers the slices' gradients."""

    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        k = x.shape[1] // comm.shard.tp
        return x.narrow(1, comm.shard.model_rank * k, k).contiguous()

    @staticmethod
    def backward(ctx, g):
        c = ctx.comm
        return _all_gather(g, c.model_group, c.shard.tp, c.stage, dim=1), None


class _VocabGather(torch.autograd.Function):
    """Vocab-slice logits all-gathered over ``model``; the backward keeps
    this rank's slice (every rank's loss reads the same full logits)."""

    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return _all_gather(x, comm.model_group, comm.shard.tp, comm.stage,
                           dim=-1)

    @staticmethod
    def backward(ctx, g):
        v0, n = ctx.comm.shard.vocab
        return g.narrow(-1, v0, n).contiguous(), None


class _ScaleGrad(torch.autograd.Function):
    """Identity forward; the gradient times ``s``."""

    @staticmethod
    def forward(ctx, x, s):
        ctx.s = s
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.s, None


def _train(comm: Optional[ShardComm]) -> bool:
    return comm is not None and comm.train


def reduce_partial(x: torch.Tensor) -> torch.Tensor:
    """Sum a row-parallel projection's partial outputs over ``model``
    (training with ``sp``: and keep this rank's sequence slice)."""
    comm = current()
    if not _model(comm):
        return x
    if comm.train:
        return (_SeqReduceScatter if comm.sp else _SumForward).apply(x, comm)
    return _sum_f32(x, comm.model_group, comm.stage)


def col_input(x: torch.Tensor) -> torch.Tensor:
    """The input of a column-parallel projection, after its norm: in
    training Megatron's ``f`` (identity forward, the sum over ``model``
    backward; with ``sp`` the sequence all-gathered); else ``x``."""
    comm = current()
    if not (_model(comm) and comm.train):
        return x
    return (_SeqGather if comm.sp else _SumBackward).apply(x, comm)


def seq_scatter(h: torch.Tensor) -> torch.Tensor:
    """Training with ``sp``: this rank's sequence slice of the embedded
    (B, S, d) stream; else ``h``."""
    comm = current()
    if not (_model(comm) and comm.train and comm.sp):
        return h
    if h.shape[1] % comm.shard.tp:
        raise ValueError(f"sequence parallelism: S = {h.shape[1]} does not "
                         f"split over tp = {comm.shard.tp}")
    return _SeqSlice.apply(h, comm)


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
    if comm.train:
        return _SumForward.apply(rows, comm).to(table.dtype)
    return _all_reduce(rows, comm.model_group, comm.stage).to(table.dtype)


def gather_vocab(logits: torch.Tensor) -> torch.Tensor:
    """Local vocab-slice logits -> replicated full logits (last dim)."""
    comm = current()
    if not _model(comm):
        return logits
    if comm.train:
        return _VocabGather.apply(logits, comm)
    return _all_gather(logits, comm.model_group, comm.shard.tp, comm.stage,
                       dim=-1)


def norm_sum(sumsq: torch.Tensor, count: torch.Tensor):
    """All-reduce a sharded norm's f32 sum of squares (..., 1) and its
    channel count (broadcastable to it) over ``model``; returns both."""
    comm = current()
    if not _model(comm):
        return sumsq, count
    count = torch.broadcast_to(count.float(), sumsq.shape)
    both = torch.cat([sumsq, count], dim=-1)
    both = (_SumBoth.apply(both, comm) if comm.train else
            _all_reduce(both, comm.model_group, comm.stage))
    return both[..., :1], both[..., 1:]


def train_aux_means(frac: torch.Tensor, pmean: torch.Tensor):
    """The MoE load-balancing loss's per-expert first-choice fraction and
    mean probability over this rank's tokens -> the terms whose
    ``e * sum(frac * pmean)``, summed over the data ranks, is the global
    batch's loss: ``frac`` averaged over ``data``, ``pmean`` divided by
    dp. Every model rank scores every expert, so ``pmean``'s gradient is
    counted once over ``model`` (scaled by 1 / tp; the partial gradients
    are summed over ``model`` after the backward). Outside training:
    unchanged."""
    comm = current()
    if not _train(comm):
        return frac, pmean
    sh = comm.shard
    if sh.tp > 1:
        pmean = _ScaleGrad.apply(pmean, 1.0 / sh.tp)
    if sh.dp > 1:
        frac = _all_reduce(frac.detach().clone(), comm.data_group,
                           comm.stage) / sh.dp
        pmean = pmean / sh.dp
    return frac, pmean


def expert_range(n_experts: int):
    """(start, size) of the MoE experts this rank holds: all of them
    outside a model-sharded context and where the rank holds a column
    slice of every expert."""
    comm = current()
    if not _model(comm) or not comm.shard.experts[1]:
        return 0, n_experts
    return comm.shard.experts


def _gather_sharded(piece: torch.Tensor, s: Sharding, mesh,
                    stage: bool) -> torch.Tensor:
    """The full leaf of shape ``s.shape`` from every rank's piece under
    ``s`` (one all-gather over the world, each piece placed by its rank's
    slices: the training layout's replicated KV heads and per-head slices
    included)."""
    if s.shape is None:
        raise ValueError(f"{'/'.join(s.keys)}: gathering a training-layout "
                         f"leaf needs its full shape "
                         f"(sharding.train_state_shardings)")
    world = C.world_size()
    parts = _all_gather(piece.unsqueeze(0), None, world, stage, dim=0)
    full = torch.empty(s.shape, dtype=piece.dtype, device=piece.device)
    grid = mesh.mesh
    for r in range(world):
        at = (grid == r).nonzero()
        if not len(at):
            continue
        coord = dict(zip(mesh.mesh_dim_names, (int(i) for i in at[0])))
        view = full
        for dim, (start, size) in s.slices(s.shape, coord).items():
            view = view.narrow(dim, start, size)
        view.copy_(parts[r])
    return full


def gather_tree(tree, specs, mesh):
    """The full tensors of a sharded pytree: every leaf all-gathered over
    the mesh axes its spec splits it on (a tuple of axes innermost first),
    the inverse of ``sharding.shard_params`` over the ranks of ``mesh``.
    ``specs`` may hold ``sharding.Sharding`` leaves (with their full
    shapes), and then a leaf is rebuilt from every rank's piece under its
    layout; dataclasses (an ``OptState``) are walked like dicts."""
    stage = C.backend() == "gloo"

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
        if isinstance(sp, Sharding):
            return _gather_sharded(t, sp, mesh, stage)
        if isinstance(t, dict):
            return {k: walk(v, sp[k]) for k, v in t.items()}
        if dataclasses.is_dataclass(t):
            return type(t)(**{f.name: walk(getattr(t, f.name),
                                           getattr(sp, f.name))
                              for f in dataclasses.fields(t)})
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
                C.all_gather(list(hrecv.unbind(0)), hsend,
                             group=own.data_group)
                recv.copy_(hrecv, non_blocking=True)
            else:
                C.all_gather(list(recv.unbind(0)), send,
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
# training: FSDP's gather of the data-split pieces
# ---------------------------------------------------------------------------


def _gather_data(comm: ShardComm, dims, pieces) -> List[torch.Tensor]:
    """Each piece all-gathered over ``data`` along its dim: one all-gather
    per dtype of the pieces flattened end to end."""
    dp = comm.shard.dp
    out: List[Optional[torch.Tensor]] = [None] * len(pieces)
    by_dtype: Dict[Any, List[int]] = {}
    for i, p in enumerate(pieces):
        by_dtype.setdefault(p.dtype, []).append(i)
    for idx in by_dtype.values():
        send = torch.cat([pieces[i].reshape(-1) for i in idx])
        recv = _all_gather(send, comm.data_group, dp, comm.stage,
                           dim=0).view(dp, -1)
        off = 0
        for i in idx:
            p, k = pieces[i], pieces[i].numel()
            out[i] = torch.cat([recv[r, off:off + k].view(p.shape)
                                for r in range(dp)], dim=dims[i])
            off += k
    return out


class _DataGather(torch.autograd.Function):
    """FSDP: pieces all-gathered over ``data`` forward; the backward
    reduce-scatters their gradients over ``data`` in the comm's gradient
    dtype (one collective, every piece's gradient cut into dp chunks and
    laid out rank by rank)."""

    @staticmethod
    def forward(ctx, comm, dims, *pieces):
        ctx.comm, ctx.dims = comm, dims
        ctx.like = [(p.shape, p.device) for p in pieces]
        return tuple(_gather_data(comm, dims, pieces))

    @staticmethod
    def backward(ctx, *grads):
        c, dims = ctx.comm, ctx.dims
        dp, gdt = c.shard.dp, c.grad_dtype
        chunks = []
        for g, (shape, dev), d in zip(grads, ctx.like, dims):
            if g is None:  # an output the loss does not reach
                full = list(shape)
                full[d] *= dp
                g = torch.zeros(full, dtype=gdt, device=dev)
            chunks.append([t.reshape(-1) for t in
                           g.to(gdt).chunk(dp, dim=d)])
        buf = torch.stack([torch.cat([ch[r] for ch in chunks])
                           for r in range(dp)])
        mine = _reduce_scatter(buf, c.data_group, dp, c.shard.data_rank,
                               c.stage, c.nccl, dim=0).reshape(-1)
        out, off = [], 0
        for shape, _ in ctx.like:
            k = math.prod(shape)
            out.append(mine[off:off + k].view(shape))
            off += k
        return (None, None) + tuple(out)


class TrainGather(GroupGather):
    """A stacked training-layout parameter tree: ``group(g)`` all-gathers
    group ``g``'s data-split pieces (``_DataGather``). Each leaf is
    unbound once, so its groups' gradients stack in one backward node."""

    def __init__(self, held, dims, comm: ShardComm):
        self.held, self.prefix, self.comm = held, (), comm
        self.paths = []
        _walk(held, lambda p, _t: self.paths.append(p))
        self.groups = {p: _at(held, p).unbind(0) for p in self.paths}
        self.dims = {p: (None if _at(dims, p) is None else _at(dims, p) - 1)
                     for p in self.paths}
        self.n_groups = len(self.groups[self.paths[0]])

    def group(self, g: int):
        got = {p: self.groups[p][g] for p in self.paths}
        split = [p for p in self.paths if self.dims[p] is not None]
        if split:
            outs = _DataGather.apply(self.comm, [self.dims[p] for p in split],
                                     *[got[p] for p in split])
            got.update(zip(split, outs))
        return _walk(self.held, lambda p, _t: got[p])


def train_view(held, comm: ShardComm, dims):
    """The tree a training forward runs on: ``held`` (this rank's
    training-layout pieces) with the leaves outside the layer stack
    gathered over ``data`` at once and the stack a ``TrainGather``.
    ``dims`` gives each leaf's data-split dim (None: not split). Without
    a data split, ``held`` itself."""
    if comm.shard.dp == 1:
        return held
    top = []
    _walk(held, lambda p, _t: top.append(p) if p[0] != "stack"
          and _at(dims, p) is not None else None)
    got = {}
    if top:
        outs = _DataGather.apply(comm, [_at(dims, p) for p in top],
                                 *[_at(held, p) for p in top])
        got = dict(zip(top, outs))
    out = _walk(held, lambda p, t: got.get(p, t) if p[0] != "stack" else t)
    if "stack" in held:
        out["stack"] = TrainGather(held["stack"], dims["stack"], comm)
    return out


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
