"""Model-facing wrappers around the port's kernels.

Port of ``repro.kernels.ops`` for flash attention and the SSD scan: each
wrapper takes the model's layout and runs the hand-written kernel on CUDA
tensors, the plain version on CPU tensors. ``morph_matmul`` is reached
through ``kernels.morph_matmul`` directly.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ssd_scan as _ssd


def flash_attention_bshd(q, k, v, *, causal: bool = True, window: int = 0,
                         bq: int = 128, bk: int = 128) -> torch.Tensor:
    """Model-layout flash attention. q: (B, Sq, H, hd); k, v: (B, Sk, KV,
    hd) -> (B, Sq, H, hd) in q's dtype, the function of
    ``kernels.flash_attention.flash_attention`` with group H / KV.

    On a card the kernel reads the model layout in place (no transposed
    copies); on the CPU the heads are flattened to (B * H, Sq, hd) and the
    plain version runs at tiles (``bq``, ``bk``), this wrapper's only knob
    (rounding only; the kernel's tiling is its own). Any Sq and Sk."""
    if q.device.type == "cpu":
        B, Sq, H, hd = q.shape
        KV, Sk = k.shape[2], k.shape[1]
        qf = q.transpose(1, 2).reshape(B * H, Sq, hd)
        kf = k.transpose(1, 2).reshape(B * KV, Sk, hd)
        vf = v.transpose(1, 2).reshape(B * KV, Sk, hd)
        o = _fa.flash_attention_plain(qf, kf, vf, group=H // KV,
                                      causal=causal, window=window, bq=bq,
                                      bk=bk)
        return o.reshape(B, H, Sq, hd).transpose(1, 2)
    q = q.contiguous()
    return _fa.launch(q, k.contiguous(), v.contiguous(), torch.empty_like(q),
                      causal=causal, window=window)


def ssd_scan_bshn(x, dt, A, B_, C_, *, chunk: int = 128
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Model-layout SSD scan. x: (b, s, h, p); dt: (b, s, h); A: (h,);
    B_, C_: (b, s, g, n). Returns (y (b, s, h, p), final_state
    (b, h, p, n)), the function of ``kernels.ssd_scan.ssd_chunked``.

    A length that is not a multiple of ``chunk`` is zero-padded on the CPU
    route (``ssd_chunked``); the kernel masks the ragged tail in place of
    the padding copy. Either way a padded step has dt = 0 and x = 0: it
    decays by 1 and adds nothing, so y at the real positions and the final
    state are unchanged. On a card B and C go to the kernel once per group,
    never repeated per head, and the call is differentiable through
    ``ssd_scan.ScanFunction`` (the backward kernel); on the CPU autograd
    differentiates ``ssd_chunked``. ``chunk`` selects only the CPU route's
    chunking (rounding only); the kernel's tiling is its own."""
    if x.device.type == "cpu":
        return _ssd.ssd_chunked(x, dt, A, B_, C_, chunk)
    b, _, h, _ = x.shape
    # expanded inside the graph, so that autograd sums dA over the batch
    A_bh = A.float().expand(b, h).contiguous()
    return _ssd.ScanFunction.apply(x.contiguous(), dt.float().contiguous(),
                                   A_bh, B_.float().contiguous(),
                                   C_.float().contiguous())
