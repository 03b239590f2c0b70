"""morph_matmul — width-morphable matmul (NeuroMorph clock-gate analogue).

Port of ``repro.kernels.morph_matmul``. x (M, K) or (B, M, K) @ w (K, N) with
f32 accumulation. ``active_n`` / ``active_k`` are ints, 0-d tensors or
per-batch ``(B,)`` int32 tensors: columns at or past ``active_n`` come out as
exact zeros and contraction rows at or past ``active_k`` contribute nothing,
so slots running different width modes share one launch. ``w`` is cast to
x's dtype (the JAX ``morph_proj`` casts f32 master weights to bf16 first);
the kernel does that cast on load.

On a CPU tensor the wrapper runs ``morph_matmul_plain``. On a CUDA tensor it
launches the hand-written kernel in ``csrc/morph_matmul.cu`` (see
``csrc/gemv.cuh`` for its design) or raises. ``launch_count()`` counts the
kernel launches made through ``morph_matmul``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple, Union

import torch

from repro_torch.kernels import _build

ActiveDim = Union[int, torch.Tensor, None]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_LAUNCHES = {"n": 0}
_TICKETS = {}
# launch geometry shared with csrc/gemv.cuh (kBN, kKC) and a block target of
# two resident blocks on each of the H100's 132 SMs
_BN, _KC, _TARGET_BLOCKS = 32, 256, 264
_P = ctypes.c_void_p
_I = ctypes.c_int


def launch_count() -> int:
    """Kernel launches made by ``morph_matmul`` since import / reset."""
    return _LAUNCHES["n"]


def reset_launch_count() -> None:
    _LAUNCHES["n"] = 0


def _active_vec(a: ActiveDim, full: int, batch: int,
                device: torch.device) -> torch.Tensor:
    """Normalize an active-dim operand to a (batch,) int32 tensor."""
    if a is None:
        a = full
    a = torch.as_tensor(a, dtype=torch.int32, device=device)
    if a.dim() == 0:
        return a.expand(batch)
    if a.shape != (batch,):
        raise ValueError(f"active dim shape {tuple(a.shape)} != ({batch},)")
    return a


def morph_matmul_plain(x: torch.Tensor, w: torch.Tensor,
                       active_n: ActiveDim = None,
                       active_k: ActiveDim = None) -> torch.Tensor:
    """The kernel's plain PyTorch version: one masked f32-accumulated product
    with ``w`` rounded to x's dtype (mirrors the JAX ``impl="ref"`` core)."""
    batched = x.dim() == 3
    if not batched:
        x = x[None]
    B, M, K = x.shape
    N = w.shape[1]
    an = _active_vec(active_n, N, B, x.device)
    ak = _active_vec(active_k, K, B, x.device)
    k_ids = torch.arange(K, device=x.device)
    xm = torch.where(k_ids[None, None, :] < ak[:, None, None], x,
                     torch.zeros((), dtype=x.dtype, device=x.device))
    y = torch.matmul(xm.float(), w.to(x.dtype).float())
    n_ids = torch.arange(N, device=x.device)
    y = torch.where(n_ids[None, None, :] < an[:, None, None], y,
                    torch.zeros((), device=x.device))
    y = y.to(x.dtype)
    return y if batched else y[0]


def _lib():
    lib = _build.load("morph_matmul")
    fn = lib.morph_matmul_launch
    if fn.argtypes is None:
        fn.argtypes = [_P, _I, _P, _I, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I,
                       _I, _I, _P, _P, _P]
        fn.restype = _I
    return fn


def _check(t: torch.Tensor, name: str, device: torch.device,
           dtypes=tuple(_DTYPE_CODE)) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}; the kernel takes {dtypes}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _gate_ptr(a: Optional[torch.Tensor], batch: int,
              device: torch.device) -> Optional[int]:
    if a is None:
        return None
    _check(a, "active width", device, (torch.int32,))
    if a.shape != (batch,):
        raise ValueError(f"active dim shape {tuple(a.shape)} != ({batch},)")
    return a.data_ptr()


def plan(n_cols: Sequence[int], K: int, rows: int,
         device: torch.device) -> Tuple[int, int, Optional[torch.Tensor],
                                         Optional[torch.Tensor]]:
    """Contraction splits for a gated product over column blocks ``n_cols``:
    (splits, k_per_split, f32 partials workspace, tickets). Enough blocks to
    fill the card, each split at least one staged chunk, no empty split."""
    tiles, splits, kps = _split_plan(tuple(n_cols), K)
    if splits == 1:
        return 1, kps, None, None
    ws = torch.empty(splits * rows * sum(n_cols), dtype=torch.float32,
                     device=device)
    return splits, kps, ws, _tickets(tiles, device)


@functools.lru_cache(maxsize=None)
def _split_plan(n_cols: Tuple[int, ...], K: int) -> Tuple[int, int, int]:
    """(tiles, splits, k_per_split) for one launch shape."""
    tiles = sum((n + _BN - 1) // _BN for n in n_cols)
    chunks = max(1, (K + _KC - 1) // _KC)
    s = max(1, min((_TARGET_BLOCKS + tiles - 1) // max(tiles, 1), chunks))
    per = (chunks + s - 1) // s
    return tiles, (chunks + per - 1) // per, per * _KC


def _tickets(n: int, device: torch.device) -> torch.Tensor:
    """Zeroed per-tile counters; the kernel leaves them zeroed again, so one
    buffer serves every launch on the stream."""
    key = str(device)
    t = _TICKETS.get(key)
    if t is None or t.numel() < n:
        t = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
        _TICKETS[key] = t
    return t


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def launch(x: torch.Tensor, w: torch.Tensor, out: torch.Tensor,
           active_n: Optional[torch.Tensor], active_k: Optional[torch.Tensor],
           *, round_w: bool) -> torch.Tensor:
    """Launch the kernel into ``out`` (B, M, N). ``active_*`` are (B,) int32
    CUDA tensors or None (full width). Not counted: callers that are
    themselves kernels of another name (the fused decode's output
    projection) use this directly; ``morph_matmul`` counts its own."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"kernel launch needs CUDA tensors, got {dev}")
    _check(x, "x", dev)
    _check(w, "w", dev)
    _check(out, "out", dev)
    B, M, K = x.shape
    K2, N = w.shape
    if K != K2 or tuple(out.shape) != (B, M, N):
        raise ValueError(f"shapes x {tuple(x.shape)} w {tuple(w.shape)} "
                         f"out {tuple(out.shape)} do not match")
    align = 16 if w.dtype == torch.float32 else 8
    vec = N % 4 == 0 and w.data_ptr() % align == 0
    splits, kps, ws, tickets = plan([N], K, B * M, dev)
    err = _lib()(x.data_ptr(), _DTYPE_CODE[x.dtype], w.data_ptr(),
                 _DTYPE_CODE[w.dtype], out.data_ptr(), _DTYPE_CODE[out.dtype],
                 _gate_ptr(active_n, B, dev), _gate_ptr(active_k, B, dev),
                 B, M, K, N, int(round_w), int(vec), splits, kps, _ptr(ws),
                 _ptr(tickets), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"morph_matmul kernel launch failed: CUDA error {err}")
    return out


def morph_matmul(x: torch.Tensor, w: torch.Tensor,
                 active_n: ActiveDim = None,
                 active_k: ActiveDim = None) -> torch.Tensor:
    """x: (M, K) or (B, M, K); w: (K, N). Returns x's dtype, zero-filled at
    and past ``active_n``."""
    if x.device.type == "cpu":
        return morph_matmul_plain(x, w, active_n, active_k)
    batched = x.dim() == 3
    x3 = x if batched else x[None]
    B, M, _ = x3.shape
    N = w.shape[1]
    an = None if active_n is None else _active_vec(active_n, N, B, x.device)
    ak = None if active_k is None else _active_vec(active_k, x3.shape[2], B,
                                                   x.device)
    an = None if an is None else an.contiguous()
    ak = None if ak is None else ak.contiguous()
    out = torch.empty((B, M, N), dtype=x.dtype, device=x.device)
    launch(x3, w, out, an, ak, round_w=x.dtype == torch.bfloat16)
    _LAUNCHES["n"] += 1
    return out if batched else out[0]
