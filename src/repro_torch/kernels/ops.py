"""Model-facing wrappers around the port's kernels.

Port of ``repro.kernels.ops`` for the SSD scan: the wrapper takes the
model's layout and runs the hand-written kernel on CUDA tensors, the plain
version on CPU tensors. ``morph_matmul`` is reached through
``kernels.morph_matmul`` directly.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import ssd_scan as _ssd


def flash_attention_bshd(*args, **kwargs):
    """Tiled causal / sliding-window attention in the model layout: arrives
    with the flash-attention slice of the port
    (``repro.kernels.ops.flash_attention_bshd`` is its reference)."""
    raise NotImplementedError("flash_attention_bshd arrives with the "
                              "flash-attention slice of the port")


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
    never repeated per head. ``chunk`` selects only the CPU route's
    chunking (rounding only); the kernel's tiling is its own."""
    if x.device.type == "cpu":
        return _ssd.ssd_chunked(x, dt, A, B_, C_, chunk)
    b, _, h, _ = x.shape
    A_bh = A.float().expand(b, h).contiguous()
    return _ssd.launch_bshn(x.contiguous(), dt.float().contiguous(), A_bh,
                            B_.float().contiguous(), C_.float().contiguous())
