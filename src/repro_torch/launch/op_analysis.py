"""Op-trace cost walker: per-rank FLOPs, HBM bytes, collective wire bytes
and peak memory of one step, from the aten ops it dispatches on meta
tensors.

The port's counterpart of ``repro.launch.hlo_analysis``. The reference
walks the compiled per-partition HLO of a cell's step; PyTorch has no
compiled program, but it has the exact stream of operations a rank's step
dispatches, and on meta tensors that stream costs no memory and needs no
card. ``trace(fn, *args)`` runs ``fn`` under a ``TorchDispatchMode`` and
records, in order:

* every aten op with its inputs' and outputs' shapes and dtypes and its
  class (``_category``): views and allocations are free; an op that makes
  a new tensor reads its operands once and writes its result once (the
  eager port's traffic, not the reference's fused-elementwise convention,
  which counts a standalone elementwise op as free because XLA:TPU fuses
  it); an in-place write into a slice (``copy_``, ``index_put_``, ...)
  reads and writes the slice, like the reference's ``dynamic-update-slice``;
  a gather moves twice its result; matrix products count ``2 M N K``
  FLOPs, every other computing op 1 FLOP per result element, as the
  reference does;
* each hand-kernel launch (the wrappers' meta route, ``kernel_launch``)
  with the FLOPs and bytes of its kernel module's ``cost``; the plain
  version's ops are not run, so not counted again;
* each collective (``parallel.collectives``, the step path's one seam)
  as (op, result bytes, group size), costed with the reference's ring
  model (``wire_bytes``, ported verbatim) in the dtype the port really
  sends; the result bytes are HBM traffic too;
* loops (``loop_range``): a microbatch loop is traced once and everything
  in it is multiplied by its trip count, as the reference multiplies a
  ``while`` body; the trips land in ``loop_trips``.

``account(events)`` turns the recorded stream into an ``OpCost``;
``launch.reanalyze`` re-runs it over a saved stream. Memory is measured
while tracing: ``peak_temp_bytes`` is the peak of the live bytes of the
storages made during the trace (one storage counted once across its
views; liveness through weakref finalizers on the tensors), and
``output_bytes`` the bytes of the new storages the step returns.

All numbers are per rank. Nothing here allocates device memory or starts
a process group.
"""
from __future__ import annotations

import dataclasses
import gzip
import json
import threading
import weakref
from collections import defaultdict
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                  "collective-permute")

# peak dense rates of the H100 SXM data sheet by operand type, for a kernel
# cost's bound (the dry-run's compute term uses ``hw.H100.peak_flops``)
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float16: 989e12,
              torch.float32: 67e12}

_STATE = threading.local()


def wire_bytes(op: str, result_bytes: float, g: int) -> float:
    """Ring-model bytes one chip sends for a collective of ``result_bytes``
    over ``g`` ranks (``repro.launch.hlo_analysis._wire_bytes``)."""
    if g <= 1:
        return 0.0
    r = (g - 1) / g
    if op.startswith("all-reduce"):
        return 2.0 * r * result_bytes
    if op.startswith("all-gather"):
        return r * result_bytes
    if op == "reduce-scatter":
        return (g - 1) * result_bytes
    if op == "all-to-all":
        return r * result_bytes
    return result_bytes  # collective-permute, send, recv, broadcast


# ---------------------------------------------------------------------------
# op classes
# ---------------------------------------------------------------------------

_FREE = {"empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "detach", "alias", "lift_fresh", "_unsafe_view",
         "resize_", "set_", "_local_scalar_dense", "is_same_size", "sym_size",
         "sym_stride", "sym_numel", "sym_storage_offset", "resolve_conj",
         "resolve_neg", "_has_compatible_shallow_copy_type", "record_stream"}
_FILL = {"zeros", "ones", "full", "zeros_like", "ones_like", "full_like",
         "new_zeros", "new_ones", "new_full", "fill_", "zero_", "arange",
         "scalar_tensor", "rand", "randn", "rand_like", "randn_like",
         "randint", "normal_", "uniform_", "bernoulli_", "random_",
         "linspace", "eye", "tril_indices", "triu_indices"}
_SLICE_WRITE = {"copy_", "index_copy_", "index_put_", "_index_put_impl_",
                "scatter_", "masked_scatter_"}
_GATHER = {"index_select", "gather", "index", "embedding", "take"}
_MATMUL = {"mm", "bmm", "addmm", "baddbmm", "addbmm", "convolution",
           "_convolution", "convolution_backward"}


_CATS: Dict[Any, Tuple[str, str]] = {}


def _classify(func) -> Tuple[str, str]:
    """(name, class) of an aten op, cached per overload."""
    hit = _CATS.get(func)
    if hit is None:
        name = func._schema.name.split("::")[-1]
        hit = _CATS[func] = (name, _category(func, name))
    return hit


def _category(func, name: str) -> str:
    if name in _FREE:
        return "free"
    if func.is_view:
        return "view"
    if name in _FILL:
        return "fill"
    if name in _SLICE_WRITE:
        return "slice_write"
    if name in _GATHER:
        return "gather"
    if name in _MATMUL:
        return "matmul"
    if func._schema.is_mutable:
        return "inplace"
    return "op"


def _flat(x, out: List[torch.Tensor]) -> List[torch.Tensor]:
    """The tensors of an aten op's arguments or results, in order (a
    cheaper ``tree_flatten`` for their lists, tuples and dicts)."""
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _flat(v, out)
    elif isinstance(x, dict):
        for v in x.values():
            _flat(v, out)
    return out


def _meta(t: torch.Tensor) -> List[Any]:
    return [list(t.shape), str(t.dtype)[6:]]


_ELEM = {}


def _elem(dtype: str) -> int:
    n = _ELEM.get(dtype)
    if n is None:
        n = _ELEM[dtype] = torch.empty((), dtype=getattr(torch, dtype)
                                       ).element_size()
    return n


def _nbytes(m) -> int:
    n = 1
    for d in m[0]:
        n *= d
    return n * _elem(m[1])


def _numel(m) -> int:
    n = 1
    for d in m[0]:
        n *= d
    return n


def _matmul_flops(name: str, ins, outs) -> float:
    """2 M N K of a product (a convolution: 2 x output elements x the
    weight's elements per output channel; its backward twice that)."""
    if name in ("mm", "bmm"):
        a = ins[0][0]
        return 2.0 * _numel(outs[0]) * a[-1]
    if name in ("addmm", "baddbmm", "addbmm"):
        a = ins[1][0]
        return 2.0 * _numel(outs[0]) * a[-1]
    w = ins[1][0]
    per_out = _numel((w[1:], "float32"))
    if name == "convolution_backward":
        return 2.0 * 2.0 * _numel(ins[0]) * per_out
    return 2.0 * _numel(outs[0]) * per_out


def _op_cost(ev) -> Tuple[float, float]:
    """(flops, bytes) of one recorded aten op."""
    cat, ins, outs = ev["cat"], ev["in"], ev["out"]
    if cat in ("view", "free"):
        return 0.0, 0.0
    out_b = sum(_nbytes(m) for m in outs)
    if cat == "fill":
        return 0.0, float(out_b)
    if cat == "slice_write":
        return 0.0, (2.0 * _nbytes(ins[-1]) if ins else 0.0)
    if cat == "gather":
        return 0.0, 2.0 * out_b
    in_b = sum(_nbytes(m) for m in ins)
    if cat == "matmul":
        return _matmul_flops(ev["op"], ins, outs), float(in_b + out_b)
    if cat == "inplace":  # reads every operand, writes self
        return float(_numel(ins[0])) if ins else 0.0, float(
            in_b + (_nbytes(ins[0]) if ins else 0))
    return float(sum(_numel(m) for m in outs)), float(in_b + out_b)


# ---------------------------------------------------------------------------
# the cost record
# ---------------------------------------------------------------------------


def _kernel_row():
    return {"launches": 0, "flops": 0.0, "bytes": 0.0}


@dataclasses.dataclass
class OpCost:
    """One rank's step: the reference's ``HloCost`` fields (``loop_trips``
    in place of ``while_trips``), the hand kernels' tally by name, and the
    memory the trace measured."""

    flops: float = 0.0
    bytes: float = 0.0
    coll_wire_bytes: float = 0.0
    coll_result_bytes: float = 0.0
    per_op_bytes: Dict[str, float] = dataclasses.field(
        default_factory=lambda: defaultdict(float))
    per_op_count: Dict[str, int] = dataclasses.field(
        default_factory=lambda: defaultdict(int))
    loop_trips: List[int] = dataclasses.field(default_factory=list)
    per_kernel: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=lambda: defaultdict(_kernel_row))
    argument_bytes: int = 0
    peak_temp_bytes: int = 0
    output_bytes: int = 0
    n_ops: int = 0
    events: List[Dict[str, Any]] = dataclasses.field(default_factory=list)

    def as_dict(self) -> Dict:
        """The reference's ``HloCost.as_dict`` keys, plus the kernels'."""
        return {
            "flops_per_device": self.flops,
            "bytes_per_device": self.bytes,
            "wire_bytes_per_chip": self.coll_wire_bytes,
            "coll_result_bytes": self.coll_result_bytes,
            "per_op_bytes": dict(self.per_op_bytes),
            "per_op_count": dict(self.per_op_count),
            "loop_trips": list(self.loop_trips),
            "per_kernel": {k: dict(v) for k, v in self.per_kernel.items()},
        }

    def launches(self) -> Dict[str, int]:
        return {k: int(v["launches"]) for k, v in self.per_kernel.items()}


def account(events: List[Dict[str, Any]]) -> OpCost:
    """The ``OpCost`` of a recorded stream (every event carries its loop
    multiplier ``mult``)."""
    cost = OpCost()
    for ev in events:
        m = ev.get("mult", 1)
        if "loop" in ev:
            cost.loop_trips.append(ev["loop"])
        elif "kernel" in ev:
            row = cost.per_kernel[ev["kernel"]]
            row["launches"] += m
            row["flops"] += m * ev["flops"]
            row["bytes"] += m * ev["bytes"]
            cost.flops += m * ev["flops"]
            cost.bytes += m * ev["bytes"]
        elif "coll" in ev:
            rb, op = ev["bytes"], ev["coll"]
            wb = wire_bytes(op, rb, ev["group"])
            cost.coll_wire_bytes += m * wb
            cost.coll_result_bytes += m * rb
            cost.per_op_bytes[op] += m * wb
            cost.per_op_count[op] += int(m)
            cost.bytes += m * rb  # collectives also touch HBM
        else:
            f, b = _op_cost(ev)
            cost.flops += m * f
            cost.bytes += m * b
            cost.n_ops += 1
    return cost


# ---------------------------------------------------------------------------
# the recorder
# ---------------------------------------------------------------------------


class _Recorder(TorchDispatchMode):
    def __init__(self, world: int, backend: str, unroll: bool):
        super().__init__()
        self.world, self.backend, self.unroll = world, backend, unroll
        self.events: List[Dict[str, Any]] = []
        self.mult = 1
        self._args: set = set()  # storage keys of the arguments
        self._live: Dict[int, List[int]] = {}  # key -> [bytes, tensors]
        self._seen: set = set()  # ids of tensors tracked
        self.live = self.peak = 0

    # memory ----------------------------------------------------------------
    @staticmethod
    def _key(t: torch.Tensor) -> int:
        return t.untyped_storage()._cdata

    def argument(self, t: torch.Tensor) -> None:
        self._args.add(self._key(t))

    def _track(self, t: torch.Tensor) -> None:
        if id(t) in self._seen:
            return
        key = self._key(t)
        if key in self._args:
            return
        ent = self._live.get(key)
        if ent is None:
            nb = t.untyped_storage().nbytes()
            ent = self._live[key] = [nb, 0]
            self.live += nb
            self.peak = max(self.peak, self.live)
        ent[1] += 1
        self._seen.add(id(t))
        weakref.finalize(t, self._release, key, id(t))

    def _release(self, key: int, tid: int) -> None:
        self._seen.discard(tid)
        ent = self._live.get(key)
        if ent is None:
            return
        ent[1] -= 1
        if ent[1] == 0:
            self.live -= ent[0]
            del self._live[key]

    # dispatch --------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = _flat(out, [])
        for t in outs:
            self._track(t)
        ins, seen = [], set()
        for t in _flat((args, kwargs), []):
            if id(t) not in seen:
                seen.add(id(t))
                ins.append(_meta(t))
        name, cat = _classify(func)
        self.events.append({"op": name, "cat": cat, "in": ins,
                            "out": [_meta(t) for t in outs],
                            "mult": self.mult})
        return out


def current() -> Optional[_Recorder]:
    """The trace this thread is recording, or None."""
    return getattr(_STATE, "rec", None)


def tracing() -> bool:
    return current() is not None


def kernel_launch(name: str, cost: Callable[[], Tuple[float, float]]
                  ) -> None:
    """A hand kernel's meta route: record one launch of ``name`` with
    ``cost()`` = (flops, bytes). Outside a trace a meta tensor has no
    kernel to run: raise."""
    rec = current()
    if rec is None:
        raise ValueError(f"{name}: a meta tensor launches no kernel outside "
                         f"an op trace (launch.op_analysis.trace)")
    flops, nbytes = cost()
    rec.events.append({"kernel": name, "flops": float(flops),
                       "bytes": float(nbytes), "mult": rec.mult})


def collective(op: str, call: str, result_bytes: float, group_size: int
               ) -> None:
    """Record one collective of ``result_bytes`` over ``group_size`` ranks
    (``call``: the ``torch.distributed`` function the port runs)."""
    rec = current()
    rec.events.append({"coll": op, "call": call, "bytes": float(result_bytes),
                       "group": int(group_size), "mult": rec.mult})


def loop_range(n: int) -> Iterator[int]:
    """``range(n)`` for a loop whose trips are alike; inside a trace (not
    unrolled) one trip runs, with every cost in it counted ``n`` times."""
    rec = current()
    if rec is None or rec.unroll or n <= 1:
        yield from range(n)
        return
    rec.events.append({"loop": int(n), "mult": rec.mult})
    prev, rec.mult = rec.mult, rec.mult * n
    try:
        yield 0
    finally:
        rec.mult = prev


def _tensors(tree) -> List[torch.Tensor]:
    out = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif dataclasses.is_dataclass(x) and not isinstance(x, type):
            for f in dataclasses.fields(x):
                walk(getattr(x, f.name))

    walk(tree)
    return out


def _storage_bytes(ts, exclude=()) -> int:
    seen, total = set(exclude), 0
    for t in ts:
        key = t.untyped_storage()._cdata
        if key not in seen:
            seen.add(key)
            total += t.untyped_storage().nbytes()
    return total


def trace(fn: Callable, *args, world: int = 1, backend: str = "nccl",
          unroll: bool = False, **kwargs) -> OpCost:
    """Run ``fn(*args, **kwargs)`` on meta tensors once and return its
    ``OpCost`` (with the recorded stream in ``events``). ``world`` is the
    number of ranks a collective over the default group spans; ``backend``
    the one the ranks would run (``parallel.collectives`` routes by it);
    ``unroll`` runs every trip of a ``loop_range``. The wrappers' own
    launch counters are left untouched."""
    from repro_torch.kernels import counted_apart

    if current() is not None:
        raise RuntimeError("op traces do not nest")
    rec = _Recorder(world, backend, unroll)
    arg_ts = _tensors((args, kwargs))
    for t in arg_ts:
        rec.argument(t)
    _STATE.rec = rec
    try:
        with counted_apart({}), rec:
            out = fn(*args, **kwargs)
    finally:
        _STATE.rec = None
    cost = account(rec.events)
    cost.events = rec.events
    cost.argument_bytes = _storage_bytes(arg_ts)
    cost.peak_temp_bytes = rec.peak
    cost.output_bytes = _storage_bytes(
        _tensors(out), exclude={t.untyped_storage()._cdata for t in arg_ts})
    return cost


def meta_like(tree):
    """``tree`` with every tensor replaced by a meta tensor of its shape,
    dtype and ``requires_grad`` (dicts, lists, tuples and dataclasses
    walked; other leaves kept)."""
    if isinstance(tree, torch.Tensor):
        t = torch.empty_like(tree, device="meta")
        return t.requires_grad_(tree.requires_grad) if tree.is_leaf else t
    if isinstance(tree, dict):
        return {k: meta_like(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(meta_like(v) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return type(tree)(**{f.name: meta_like(getattr(tree, f.name))
                             for f in dataclasses.fields(tree)})
    return tree


# ---------------------------------------------------------------------------
# saved streams
# ---------------------------------------------------------------------------


def save_events(path: str, cost: OpCost, header: Dict[str, Any]) -> None:
    """The recorded stream as gzipped JSON: ``header`` (the cell, world)
    and one event per line of the ``events`` list."""
    with gzip.open(path, "wt") as f:
        json.dump({"header": header, "memory": {
            "argument_bytes": cost.argument_bytes,
            "temp_bytes": cost.peak_temp_bytes,
            "output_bytes": cost.output_bytes},
            "events": cost.events}, f, separators=(",", ":"))


def load_events(path: str) -> Dict[str, Any]:
    with gzip.open(path, "rt") as f:
        return json.load(f)
