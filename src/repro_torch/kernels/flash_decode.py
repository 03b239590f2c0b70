"""flash_decode — single-token attention over an (optionally int8) KV cache.

Port of ``repro.kernels.flash_decode``. Layout as there: q (BH, hd); k and v
(BKV, S, hd) in f32, bf16 or int8; with an int8 cache, per-row scales
(BKV, S, 1) (``layers.quantize_kv`` gives them in bf16; f32 is taken too).
Query row bh reads KV row bh // group. Positions >= ``kv_len`` are masked
and whole tiles past it are skipped; out (BH, hd) in q's dtype.

``kv_len`` is a Python int or a 0-d / 1-element int32 tensor on q's device.
On a card the kernel reads the tensor from device memory: no host sync, and
one build serves every length (the counterpart of the TPU kernel's scalar
prefetch). With ``kv_len`` = 0 the kernel skips every tile and writes
zeros, as the TPU kernel does; ``ref.flash_decode_ref`` returns the mean of
v there instead.

The reference has no model caller: ``flash_decode`` is its own entry point.
In the port the encoder-decoder cross-attention decode calls it on a card
(``layers.mha_decode(cross=True)``: every encoder position valid, so
``kv_len`` = enc_seq). On CPU tensors it runs ``flash_decode_plain``, a tiled mirror of the TPU
kernel at ``bk``-row tiles; on CUDA tensors it launches the hand-written
kernel in ``csrc/flash_decode.cu`` or raises. The kernel is the shared
decode-attention core (``csrc/decode_attn.cuh``; its 64-row chunks split
over one thread block cluster per KV row, sized by ``decode_attn``). The
route is chosen by the cache's dtype: bf16 and int8 caches go to the tensor
cores (route ``"tc"``: bf16 products with f32 sums, f32 queries split into
two bf16 halves, p into two), f32 caches to f32 FMAs (route ``"fma"``).
``launch_count()`` counts its launches, ``route_counts()`` by the route
the kernel reports it launched. ``cost`` gives one launch's work.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Union

import torch

from repro_torch.kernels import _build, launch_counter, refuse_grad
from repro_torch.kernels import decode_attn as _da
from repro_torch.kernels import morph_matmul as _mm
from repro_torch.launch.op_analysis import kernel_launch

NEG_INF = -1e30
_Q_CODE = {torch.float32: 0, torch.bfloat16: 1}
_CACHE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_LAUNCHES = {"n": 0, "tc": 0, "fma": 0}
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

KvLen = Union[int, torch.Tensor]


def launch_count() -> int:
    """Kernel launches since import / reset."""
    return _LAUNCHES["n"]


def route_counts() -> dict:
    """Launches per kernel route since import / reset, as the launch
    reports it: ``tc`` (bf16 or int8 cache, tensor cores) and ``fma`` (f32
    cache, f32 FMAs)."""
    return {r: _LAUNCHES[r] for r in ("tc", "fma")}


def reset_launch_count() -> None:
    for k in _LAUNCHES:
        _LAUNCHES[k] = 0


def _check_shapes(q, k, v, k_scale, v_scale, group):
    BH, hd = q.shape
    BKV, S, hd_k = k.shape
    if BH != BKV * group or hd_k != hd or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)} do not fit group {group}")
    if k.dtype == torch.int8:
        for name, s in (("k_scale", k_scale), ("v_scale", v_scale)):
            if s is None or tuple(s.shape) != (BKV, S, 1):
                raise ValueError(f"an int8 cache needs {name} of shape "
                                 f"{(BKV, S, 1)}")


def flash_decode_plain(q, k, v, kv_len: KvLen, k_scale=None, v_scale=None,
                       *, group: int = 1, bk: int = 128):
    """The kernel's plain PyTorch version: the TPU kernel's loop over
    ``bk``-row tiles (the last one may be short) with running (max, sum,
    acc) in f32; tiles at or past ``kv_len`` are skipped, masked columns of
    a live tile get -1e30. Reads ``kv_len`` on the host."""
    _check_shapes(q, k, v, k_scale, v_scale, group)
    BH, hd = q.shape
    BKV, S, _ = k.shape
    n = int(kv_len)
    dev = q.device
    scale = 1.0 / math.sqrt(hd)
    qf = q.float().reshape(BKV, group, hd)
    m = torch.full((BKV, group), NEG_INF, device=dev)
    l = torch.zeros((BKV, group), device=dev)
    acc = torch.zeros((BKV, group, hd), device=dev)
    for k0 in range(0, S, bk):
        if k0 >= n:  # tile-level gating on the live cache length
            break
        k1 = min(k0 + bk, S)
        kt, vt = k[:, k0:k1].float(), v[:, k0:k1].float()
        if k.dtype == torch.int8:
            kt = kt * k_scale[:, k0:k1].float()
            vt = vt * v_scale[:, k0:k1].float()
        s = torch.einsum("bgh,bsh->bgs", qf, kt) * scale
        cols = torch.arange(k0, k1, device=dev)
        s = torch.where(cols < n, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bgs,bsh->bgh", p, vt)
        m = m_new
    out = acc / torch.clamp(l, min=1e-20)[..., None]
    return out.reshape(BH, hd).to(q.dtype)


def cost(q_shape, k_shape, q_dtype: torch.dtype, cache_dtype: torch.dtype,
         kv_len=None, *, group: int = 1,
         scale_dtype: torch.dtype = torch.bfloat16) -> tuple:
    """(FLOPs, bytes) of one launch: the live K and V rows (``kv_len``;
    None or a meta tensor: all S) read once, with their scales for an int8
    cache, q read once and the output written once; 4 hd per live row and
    query head."""
    bkv, s, d = k_shape
    n = s if kv_len is None or getattr(kv_len, "is_meta", False) else \
        min(int(kv_len), s)
    quant = cache_dtype == torch.int8
    nbytes = (n * bkv * d * 2 * cache_dtype.itemsize
              + 2 * bkv * group * d * q_dtype.itemsize
              + (2 * n * bkv * scale_dtype.itemsize if quant else 0))
    return float(4 * d * n * bkv * group), float(nbytes)


def _lib():
    lib = _build.load("flash_decode")
    fn, probe = lib.flash_decode_launch, lib.flash_decode_probe
    if fn.argtypes is None:
        args = [_P, _I, _P, _P, _I, _P, _P, _I, _P, _I, _P, _I, _I, _I, _I,
                _I, _I]
        fn.argtypes = args + [_F, _P, _P]
        fn.restype = _I
        probe.argtypes = args + [_I, _P]
        probe.restype = _I
    return fn, probe


def plan(BKV: int, group: int, S: int, q_dtype: torch.dtype,
         cache_dtype: torch.dtype, hd: int, device) -> tuple:
    """(splits, rows per split) of the launch (``decode_attn.plan``: one
    cluster per KV row and group of 16 heads)."""
    return _da.plan("flash_decode", "flash_decode_max_clusters",
                    (_Q_CODE[q_dtype], _CACHE_CODE[cache_dtype], hd), BKV,
                    group, S, device)


_PROBES = ("empty", "skeleton")


def _launch(q, k, v, kv_len, k_scale, v_scale, group, probe=None):
    """Launch the kernel and return (out, route), or with ``probe`` one of
    ``_PROBES`` at the kernel's launch shape and return (out, None)."""
    refuse_grad("flash_decode", q, k, v, k_scale, v_scale)
    if q.is_meta:
        if probe is None:
            kernel_launch("flash_decode", lambda: cost(
                q.shape, k.shape, q.dtype, k.dtype, kv_len, group=group,
                scale_dtype=(k_scale.dtype if k_scale is not None
                             else torch.bfloat16)))
        return torch.empty_like(q), (None if probe else
                                     "fma" if k.dtype == torch.float32
                                     else "tc")
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"kernel launch needs CUDA tensors, got {dev}")
    _check_shapes(q, k, v, k_scale, v_scale, group)
    quant = k.dtype == torch.int8
    named = [("q", q, _Q_CODE), ("k", k, _CACHE_CODE), ("v", v, (k.dtype,))]
    if quant:
        named += [("k_scale", k_scale, _Q_CODE),
                  ("v_scale", v_scale, (k_scale.dtype,))]
    for name, t, dtypes in named:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if t.dtype not in dtypes:
            raise TypeError(f"{name} has dtype {t.dtype}; the kernel takes "
                            f"{tuple(dtypes)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    len_ptr, len_host = None, 0
    if isinstance(kv_len, torch.Tensor):
        if (kv_len.device != dev or kv_len.dtype != torch.int32
                or kv_len.numel() != 1 or not kv_len.is_contiguous()):
            raise ValueError(f"kv_len must be one int32 on {dev}, got "
                             f"{kv_len.dtype} {tuple(kv_len.shape)} on "
                             f"{kv_len.device}")
        len_ptr = kv_len.data_ptr()
    else:
        len_host = int(kv_len)
    BH, hd = q.shape
    BKV, S, _ = k.shape
    if hd > _da.MAX_HD:
        raise ValueError(f"the kernel takes hd <= {_da.MAX_HD}, got {hd}")
    splits, rows = plan(BKV, group, S, q.dtype, k.dtype, hd, dev)
    out = torch.empty_like(q)
    args = (q.data_ptr(), _Q_CODE[q.dtype], k.data_ptr(), v.data_ptr(),
            _CACHE_CODE[k.dtype], k_scale.data_ptr() if quant else None,
            v_scale.data_ptr() if quant else None,
            _Q_CODE[k_scale.dtype] if quant else 0, len_ptr, len_host,
            out.data_ptr(), BKV, group, S, hd, splits, rows)
    stream = torch.cuda.current_stream(dev).cuda_stream
    fn, probe_fn = _lib()
    route = ctypes.c_int(-1)
    if probe is None:
        err = fn(*args, 1.0 / math.sqrt(hd), ctypes.byref(route), stream)
    else:
        err = probe_fn(*args, _PROBES.index(probe), stream)
    if err != 0:
        raise RuntimeError(f"flash_decode kernel launch failed: CUDA error "
                           f"{err}")
    return out, None if probe else _da.ROUTES[route.value]


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           kv_len: KvLen, k_scale: Optional[torch.Tensor] = None,
           v_scale: Optional[torch.Tensor] = None, *,
           group: int = 1) -> torch.Tensor:
    """Launch the kernel. q (BH, hd) f32 or bf16, hd <= 128; k, v (BKV, S,
    hd) f32, bf16 or int8 (then scales (BKV, S, 1) f32 or bf16); all
    contiguous on one CUDA device; ``kv_len`` an int or an int32 tensor of
    one element on that device. Returns (BH, hd) in q's dtype. Counted,
    and by route."""
    out, route = _launch(q, k, v, kv_len, k_scale, v_scale, group)
    c = launch_counter(_LAUNCHES, "flash_decode")
    c["n"] += 1
    c[route] += 1
    return out


def probe_launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 kv_len: KvLen, k_scale: Optional[torch.Tensor] = None,
                 v_scale: Optional[torch.Tensor] = None, *,
                 group: int = 1, kind: str = "empty") -> None:
    """Launch a probe at the grid, cluster shape and shared memory that
    ``launch`` would use for these inputs, to read what a launch of this
    shape costs under a timer before its work: ``kind="empty"`` an empty
    kernel; ``"skeleton"`` the kernel's chain of dependent steps alone (each
    block reads kv_len from device memory, then loads its first cache row,
    then passes the merge's two cluster barriers). Not counted."""
    if kind not in _PROBES:
        raise ValueError(f"kind must be one of {_PROBES}, got {kind!r}")
    _launch(q, k, v, kv_len, k_scale, v_scale, group, kind)


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 kv_len: KvLen, k_scale: Optional[torch.Tensor] = None,
                 v_scale: Optional[torch.Tensor] = None, *, group: int = 1,
                 bk: int = 128) -> torch.Tensor:
    """q: (BH, hd); k, v: (BKV, S, hd); scales (BKV, S, 1) iff the cache is
    int8. ``bk`` tiles the plain version on the CPU; the kernel ignores
    it."""
    if bk < 1:
        raise ValueError(f"bk must be positive, got {bk}")
    if q.device.type == "cpu":
        return flash_decode_plain(q, k, v, kv_len, k_scale, v_scale,
                                  group=group, bk=bk)
    return launch(q, k, v, kv_len, k_scale, v_scale, group=group)
