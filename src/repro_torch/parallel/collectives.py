"""The one seam between the step path and ``torch.distributed``.

Every collective a rank's serving, prompt or training step makes goes
through here: the tensor-parallel and FSDP collectives
(``parallel.tensor_parallel``), the optimizer's clipping norm
(``optim.optimizer.global_norm``), ``runtime.compression.compressed_psum``
and the pipeline's sends (``parallel.pipeline_parallel``). Outside an op
trace each function is the ``torch.distributed`` call of its name, made
as before. Inside one (``launch.op_analysis.trace``) no process group
exists: each call records (op, result bytes, group size) with the trace
and leaves its meta tensors as they are, ``backend`` and ``world_size``
answer for the ranks the trace stands for, and a ``TraceMesh`` stands in
for the ``DeviceMesh`` (its groups carry their sizes from the mesh).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from repro_torch.launch import op_analysis as OA


@dataclasses.dataclass(frozen=True)
class TraceGroup:
    """One mesh axis's process group inside a trace: its size and this
    rank's index in it."""

    axis: str
    size: int
    rank: int = 0


class TraceMesh:
    """A ``DeviceMesh`` stand-in for tracing one rank of a mesh of
    ``sizes`` ({axis: size}) at ``coord`` (0 on every axis by default):
    what ``parallel.sharding`` and the step builders read of a mesh."""

    def __init__(self, sizes: Dict[str, int],
                 coord: Optional[Dict[str, int]] = None):
        self.sizes = dict(sizes)
        self.coord = {a: 0 for a in sizes} if coord is None else dict(coord)
        self.mesh_dim_names = tuple(sizes)
        self.mesh = torch.empty(tuple(sizes.values()), device="meta")

    def get_group(self, axis: str) -> TraceGroup:
        return TraceGroup(axis, self.sizes[axis], self.coord[axis])

    def get_local_rank(self, axis: str) -> int:
        return self.coord[axis]


def _size(group) -> int:
    if isinstance(group, TraceGroup):
        return group.size
    return OA.current().world


def backend(group=None) -> str:
    rec = OA.current()
    return dist.get_backend(group) if rec is None else rec.backend


def world_size(group=None) -> int:
    if OA.current() is None:
        return dist.get_world_size(group)
    return _size(group)


def group_rank(group) -> int:
    """This rank's index in ``group``."""
    if OA.current() is None:
        return dist.get_group_rank(group, dist.get_rank())
    return group.rank if isinstance(group, TraceGroup) else 0


def global_rank(group, i: int) -> int:
    if OA.current() is None:
        return dist.get_global_rank(group, i)
    return i


def _bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def all_reduce(t: torch.Tensor, op=dist.ReduceOp.SUM, group=None):
    if OA.current() is None:
        return dist.all_reduce(t, op=op, group=group)
    OA.collective("all-reduce", "all_reduce", _bytes(t), _size(group))


def all_gather(parts: List[torch.Tensor], t: torch.Tensor, group=None):
    if OA.current() is None:
        return dist.all_gather(parts, t, group=group)
    OA.collective("all-gather", "all_gather", sum(_bytes(p) for p in parts),
                  _size(group))


def reduce_scatter_tensor(out: torch.Tensor, src: torch.Tensor, group=None):
    if OA.current() is None:
        return dist.reduce_scatter_tensor(out, src, group=group)
    OA.collective("reduce-scatter", "reduce_scatter_tensor", _bytes(out),
                  _size(group))


def send(t: torch.Tensor, dst: int, group=None):
    if OA.current() is None:
        return dist.send(t, dst=dst, group=group)
    OA.collective("send", "send", _bytes(t), _size(group))


def recv(t: torch.Tensor, src: int, group=None):
    if OA.current() is None:
        return dist.recv(t, src=src, group=group)
    OA.collective("recv", "recv", _bytes(t), _size(group))


def broadcast(t: torch.Tensor, src: int, group=None):
    if OA.current() is None:
        return dist.broadcast(t, src=src, group=group)
    OA.collective("broadcast", "broadcast", _bytes(t), _size(group))
