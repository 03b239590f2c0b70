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

``MeshStep`` wraps a step callable for one rank: it cuts the per-slot
operands to the rank's slots (when slots split over ``data``), turns the
global prefix widths into local ones (``localize``), runs the step inside
the context and all-gathers its per-slot outputs over ``data``.

Over gloo with CUDA tensors (ranks sharing one card) each collective stages
through host memory.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

from repro_torch.parallel.sharding import _ACTIVE_KEYS, ServeShard

_CTX = threading.local()


class ShardComm:
    """A rank's shard plan plus the process groups of its mesh axes."""

    def __init__(self, shard: ServeShard, model_group=None, data_group=None,
                 stage: bool = False):
        self.shard = shard
        self.model_group = model_group
        self.data_group = data_group
        self.stage = stage  # gloo over CUDA tensors: go through the host


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
    operand and result whole (a prompt pass, replicated over ``data``)."""

    def __init__(self, fn, comm: ShardComm, n_lead: int = 2,
                 slots: bool = True):
        self.fn, self.comm, self.n_lead = fn, comm, n_lead
        # False: a call whose operands are not per slot (a prompt pass)
        self.split = slots and comm.shard.split_slots
        self._local: Dict[int, Any] = {}  # id(active) -> (active, local)

    def _operand(self, x):
        sh = self.comm.shard
        if _is_active(x):
            hit = self._local.get(id(x))
            if hit is not None and hit[0] is x:
                return hit[1]
            loc = localize({k: self._operand(v) for k, v in x.items()}, sh)
            if len(self._local) > 256:
                self._local.clear()
            self._local[id(x)] = (x, loc)
            return loc
        if (self.split and isinstance(x, torch.Tensor) and x.dim()
                and x.shape[0] == sh.n_slots):
            return x.narrow(0, sh.slots[0], sh.slots[1])
        return x

    def _output(self, y, cache):
        sh = self.comm.shard
        if (self.split and isinstance(y, torch.Tensor) and y is not cache
                and y.dim() and y.shape[0] == sh.slots[1]):
            return _all_gather(y, self.comm.data_group, sh.dp,
                               self.comm.stage, dim=0)
        return y

    def __call__(self, *args):
        lead = args[:self.n_lead]
        rest = [self._operand(a) for a in args[self.n_lead:]]
        with shard_context(self.comm):
            out = self.fn(*lead, *rest)
        cache = lead[1] if len(lead) > 1 else None
        if isinstance(out, tuple):
            return tuple(self._output(y, cache) for y in out)
        return self._output(out, cache)
