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
``csrc/gemv.cuh`` for its design) or raises: with bf16 x the product runs
on the tensor cores (bf16 operands, f32 sums, exactly the plain version's
function), with f32 x in f32 FMAs. ``launch_count()`` counts the kernel
launches made through ``morph_matmul``. ``cost`` gives one launch's work.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple, Union

import torch

from repro_torch.kernels import (_build, host_widths, launch_counter,
                                 refuse_grad)
from repro_torch.launch.op_analysis import kernel_launch

ActiveDim = Union[int, torch.Tensor, None]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_LAUNCHES = {"n": 0}
# launch geometry shared with csrc/gemv.cuh: 64-column tiles (kBN), chunks of
# 64 contraction rows (kKC), at most 16 splits per tile (kMaxSplits: the
# splits of a tile form one thread block cluster)
_BN, _KC, _MAX_SPLITS = 64, 64, 16
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


def cost(x_shape, w_shape, x_dtype: torch.dtype, w_dtype: torch.dtype,
         active_n=None, active_k=None) -> Tuple[float, float]:
    """(FLOPs, bytes) of one launch: the live weight block (the widest
    slot's rows and columns) read once in ``w_dtype``, x read once and the
    output written once in ``x_dtype``; 2 x live rows x live columns per
    output row. ``active_*`` as the wrapper takes them (None or meta: the
    full width)."""
    B, M, K = (1,) + tuple(x_shape) if len(x_shape) == 2 else tuple(x_shape)
    N = w_shape[1]
    an = [min(a, N) for a in host_widths(active_n, N, B)]
    ak = [min(a, K) for a in host_widths(active_k, K, B)]
    live_w = max(ak) * max(an)
    nbytes = live_w * w_dtype.itemsize + B * M * (K + N) * x_dtype.itemsize
    return float(M * sum(2 * k * n for k, n in zip(ak, an))), float(nbytes)


def _lib():
    lib = _build.load("morph_matmul")
    fn = lib.morph_matmul_launch
    if fn.argtypes is None:
        fn.argtypes = [_P, _I, _P, _I, _P, _I, _P, _P] + [_I] * 7 + [_P]
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


def plan(n_cols: Sequence[int], K: int, rows: int, x_dtype: torch.dtype,
         w_dtype: torch.dtype, round_w: bool,
         device: torch.device) -> Tuple[int, int]:
    """Contraction splits for a gated product over column blocks ``n_cols``
    with ``rows`` rows: (splits, k_per_split). The splits of a column tile
    run as one cluster; the plan takes the most splits (at most
    ``_MAX_SPLITS``) for which every tile's cluster fits on the card at
    once, as the kernel's occupancy query reports, so that the launch is
    one wave. The kernel adds the splits' partials in shared memory, so a
    plan needs no workspace. Cached per shape."""
    code = (_DTYPE_CODE[x_dtype], _DTYPE_CODE[w_dtype], int(round_w))
    caps = _cluster_caps(code, rows, _device_index(device))
    return _split_plan(tuple(n_cols), K, caps)[1:]


def _device_index(device: torch.device) -> int:
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"a launch plan needs a CUDA device, got {dev}")
    return dev.index if dev.index is not None else torch.cuda.current_device()


@functools.lru_cache(maxsize=None)
def _cluster_caps(code: Tuple[int, int, int], rows: int,
                  device_index: int) -> Tuple[int, ...]:
    """Clusters of s = 1 .. _MAX_SPLITS blocks of the kernel for these
    dtypes and rows that fit on the card at once."""
    fn = _build.load("morph_matmul").morph_matmul_max_clusters
    if fn.argtypes is None:
        fn.argtypes = [_I] * 5 + [_P]
        fn.restype = _I
    caps = []
    with torch.cuda.device(device_index):
        for s in range(1, _MAX_SPLITS + 1):
            n = ctypes.c_int(0)
            err = fn(*code, rows, s, ctypes.byref(n))
            if err != 0:
                raise RuntimeError(f"morph_matmul occupancy query failed: "
                                   f"CUDA error {err}")
            caps.append(n.value)
    return tuple(caps)


@functools.lru_cache(maxsize=None)
def _split_plan(n_cols: Tuple[int, ...], K: int,
                caps: Tuple[int, ...]) -> Tuple[int, int, int]:
    """(tiles, splits, k_per_split) for one launch shape, given ``caps[s -
    1]``, the clusters of s blocks that fit on the card at once: the most
    splits whose clusters all fit (one split when none does), no more
    splits than 64-row chunks, none of them empty."""
    tiles = sum((n + _BN - 1) // _BN for n in n_cols)
    chunks = max(1, (K + _KC - 1) // _KC)
    s = 1
    for cand in range(min(len(caps), chunks), 1, -1):
        if caps[cand - 1] >= tiles:
            s = cand
            break
    per = (chunks + s - 1) // s
    return tiles, (chunks + per - 1) // per, per * _KC


def launch(x: torch.Tensor, w: torch.Tensor, out: torch.Tensor,
           active_n: Optional[torch.Tensor], active_k: Optional[torch.Tensor],
           *, round_w: bool) -> torch.Tensor:
    """Launch the kernel into ``out`` (B, M, N). ``active_*`` are (B,) int32
    CUDA tensors or None (full width). Not counted: callers that are
    themselves kernels of another name (the fused decode's output
    projection) use this directly; ``morph_matmul`` counts its own."""
    refuse_grad("morph_matmul", x, w)
    if x.is_meta:
        kernel_launch("morph_matmul", lambda: cost(
            x.shape, w.shape, x.dtype, w.dtype, active_n, active_k))
        return out
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
    splits, kps = plan([N], K, B * M, x.dtype, w.dtype, round_w, dev)
    err = _lib()(x.data_ptr(), _DTYPE_CODE[x.dtype], w.data_ptr(),
                 _DTYPE_CODE[w.dtype], out.data_ptr(), _DTYPE_CODE[out.dtype],
                 _gate_ptr(active_n, B, dev), _gate_ptr(active_k, B, dev),
                 B, M, K, N, int(round_w), splits, kps,
                 torch.cuda.current_stream(dev).cuda_stream)
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
    launch_counter(_LAUNCHES, "morph_matmul")["n"] += 1
    return out if batched else out[0]
