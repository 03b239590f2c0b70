"""Gradient compression: int8 quantization with error feedback.

Port of ``repro.runtime.compression``. Quantizing a gradient to int8
against its absmax scale cuts the bytes a cross-host reduction moves 4x
against f32; error feedback (Seide et al.) keeps each step's quantization
residual and adds it to the next step's gradient, so the accumulated update
stays unbiased. ``compressed_psum`` is the reduction itself over a
``torch.distributed`` group.

Trees are nested dicts of tensors, as the port's params and grads are.
"""
from __future__ import annotations

from typing import Tuple

import torch


def _map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 q, f32 scale) with ``scale = max(|x|) / 127`` (at least
    1e-12) and ``q = clip(round(x / scale), -127, 127)``, rounding half
    to even."""
    x32 = x.float()
    scale = torch.clamp(x32.abs().max() / 127.0, min=1e-12)
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_with_feedback(grads, error_buf):
    """(tree of (q, scale) pairs, new error buffer): each leaf quantizes
    ``g + e`` and keeps ``g + e - dequantize(q, scale)`` as its error."""

    def one(g, e):
        target = g.float() + e
        q, s = quantize(target)
        return (q, s), target - dequantize(q, s)

    out = _map(one, grads, error_buf)

    def split(node, i):
        if isinstance(node, dict):
            return {k: split(v, i) for k, v in node.items()}
        return node[i]

    return split(out, 0), split(out, 1)


def compressed_psum(grads, error_buf, group=None):
    """int8 all-reduce with error feedback over the ranks of ``group``
    (the default group when None); returns (the mean over the ranks of
    each leaf, the new error buffer).

    The ranks first agree on a global absmax scale (an all-reduce MAX of
    the local ``max|g + e| / 127``, at least 1e-12), quantize against it,
    and sum the int8 payload as int32 (exact for up to 2^23 ranks); the
    sum times the scale over the world size is the mean. Each rank keeps
    its own quantization residual as its error, so the accumulated update
    is unbiased."""
    import torch.distributed as dist

    from repro_torch.parallel import collectives as C

    n = C.world_size(group)
    stage = C.backend(group) == "gloo"

    def reduce(t, op):
        h = t.cpu() if stage and t.is_cuda else t
        C.all_reduce(h, op=op, group=group)
        return h.to(t.device)

    def one(g, e):
        target = g.float() + e
        local = (target.abs().max() / 127.0).reshape(1)
        s = torch.clamp(reduce(local, dist.ReduceOp.MAX), min=1e-12)[0]
        q = torch.clamp(torch.round(target / s), -127, 127).to(torch.int8)
        total = reduce(q.to(torch.int32), dist.ReduceOp.SUM)
        return total.float() * s / float(n), target - dequantize(q, s)

    out = _map(one, grads, error_buf)

    def split(node, i):
        if isinstance(node, dict):
            return {k: split(v, i) for k, v in node.items()}
        return node[i]

    return split(out, 0), split(out, 1)


def init_error_buffer(grads_template):
    """f32 zeros shaped like each leaf, on its device."""
    return _map(lambda a: torch.zeros(a.shape, dtype=torch.float32,
                                      device=a.device), grads_template)
