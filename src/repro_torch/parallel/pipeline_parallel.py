"""Pipeline parallelism over a mesh axis with point-to-point sends.

Port of ``repro.parallel.pipeline_parallel``. GPipe schedule: each rank on
the ``axis`` of the mesh is one stage and holds its own stage's parameters.
Microbatches stream through the stages: at tick ``t`` stage ``s`` runs
microbatch ``t - s`` (when ``0 <= t - s < M``), stage 0 taking it from the
input and every other stage receiving it from stage ``s - 1``, and sends its
output on to stage ``s + 1``. Total ticks ``T = M + S - 1``; the bubble
fraction is ``(S - 1) / (M + S - 1)`` (``bubble_fraction``). The last
stage's outputs are broadcast to every stage at the end.

The mapping of the paper's streamed, fully pipelined FPGA dataflow:
pipeline fill and drain are the line buffers' warm-up, the stage registers
the activations handed from stage to stage.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.parallel import collectives as C


def bubble_fraction(n_micro: int, n_stages: int) -> float:
    return (n_stages - 1) / (n_micro + n_stages - 1)


def pipeline_apply(stage_params, x: torch.Tensor, fn: Callable, mesh, *,
                   axis: str = "pod", n_micro: int = 4) -> torch.Tensor:
    """Run ``fn(params_s, h) -> h`` through every stage of ``axis``.

    ``stage_params``: this rank's stage's parameters, a tensor or a dict of
    them with a leading dim of 1 (the rank's shard of a stack whose leading
    dim is the stage count, split over ``axis``). ``x`` (batch, ...): the
    global input, the same on every rank, split into ``n_micro``
    microbatches; ``fn`` keeps each microbatch's shape. Returns the output
    after every stage has processed every microbatch, on every rank."""
    group = mesh.get_group(axis)
    n_stages = C.world_size(group)
    s = C.group_rank(group)
    B = x.shape[0]
    if B % n_micro:
        raise ValueError(f"batch {B} does not split into {n_micro} "
                         f"microbatches")
    xs = x.reshape((n_micro, B // n_micro) + tuple(x.shape[1:]))
    params_me = (stage_params[0] if isinstance(stage_params, torch.Tensor)
                 else {k: v[0] for k, v in stage_params.items()})
    stage = C.backend(group) == "gloo" and x.is_cuda

    def peer(i):
        return C.global_rank(group, i)

    outputs = torch.zeros_like(xs)
    for t in range(n_micro + n_stages - 1):
        m = t - s
        if not 0 <= m < n_micro:
            continue
        if s == 0:
            h = xs[m]
        else:
            h = torch.empty_like(xs[m], device="cpu" if stage else x.device)
            C.recv(h, src=peer(s - 1), group=group)
            h = h.to(x.device)
        h = fn(params_me, h)
        if s < n_stages - 1:
            C.send(h.cpu() if stage else h.contiguous(), dst=peer(s + 1),
                   group=group)
        else:
            outputs[m] = h
    out = outputs.cpu() if stage else outputs
    C.broadcast(out, src=peer(n_stages - 1), group=group)
    return out.to(x.device).reshape(x.shape)
