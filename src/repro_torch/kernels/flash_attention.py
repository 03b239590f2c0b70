"""flash_attention — tiled causal / sliding-window GQA attention.

Port of ``repro.kernels.flash_attention``. Layout as there: q (BH, Sq, hd),
k and v (BKV, Sk, hd) with BH = BKV * group; query row bh reads KV row
bh // group. Out (BH, Sq, hd) in q's dtype. The mask is additive and
finite (-1e30) for cols > rows (causal) and cols <= rows - window (sliding
window), and key tiles that lie wholly past the causal frontier or behind
the window are skipped, as in the TPU kernel. ``ops.flash_attention_bshd``
reaches the same kernel in the model layout.

Unlike the reference, which asserts that the tiles divide Sq and Sk, any
lengths are taken: the last query tile and the last key tile are cut short
(the kernel masks them). The function does not change: rows and columns past
the ends are simply not there.

On a CPU tensor ``flash_attention`` runs ``flash_attention_plain``, a tiled
mirror of the TPU kernel at tiles (``bq``, ``bk``). On CUDA tensors it
launches a hand-written kernel in ``csrc/flash_attention.cu`` (64 x 64
tiles of its own) or raises; ``bq`` and ``bk`` select only the plain
version's tiling (rounding only). The kernel is chosen by dtype: bf16
inputs go to the tensor-core kernel (route ``"tc"``: bf16 products, f32
sums, p split into two bf16 halves so that P.V keeps an f32 p), f32 inputs
to the f32 FMA kernel (route ``"fma"``). ``launch_count()`` counts the
launches of both, from either entry point; ``route_counts()`` by route.
``cost`` gives one launch's work.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import torch

from repro_torch.kernels import _build, launch_counter, refuse_grad
from repro_torch.launch.op_analysis import kernel_launch

NEG_INF = -1e30
_LAUNCHES = {"n": 0, "tc": 0, "fma": 0}
_ROUTE = {torch.bfloat16: "tc", torch.float32: "fma"}
_MAX_HD = 128  # kMaxHD in csrc/flash_attention.cu
_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float


def launch_count() -> int:
    """Kernel launches since import / reset."""
    return _LAUNCHES["n"]


def route_counts() -> dict:
    """Launches per kernel route since import / reset: ``tc`` (bf16 inputs,
    tensor cores) and ``fma`` (f32 inputs, f32 FMAs)."""
    return {r: _LAUNCHES[r] for r in ("tc", "fma")}


def reset_launch_count() -> None:
    for k in _LAUNCHES:
        _LAUNCHES[k] = 0


def flash_attention_plain(q, k, v, *, group: int, causal: bool = True,
                          window: int = 0, bq: int = 128, bk: int = 128):
    """The kernel's plain PyTorch version: the TPU kernel's loop over
    (bq, bk) tiles with running (max, sum, acc) in f32, the same skipped
    tiles and the same finite -1e30 mask. p stays in f32 for P.V."""
    BH, Sq, hd = q.shape
    BKV, Sk, _ = k.shape
    if BH != BKV * group:
        raise ValueError(f"q has {BH} rows, expected {BKV} x group {group}")
    if bq < 1 or bk < 1:
        raise ValueError(f"tiles must be positive, got ({bq}, {bk})")
    scale = 1.0 / math.sqrt(hd)
    dev = q.device
    qf = q.float().reshape(BKV, group, Sq, hd)
    kf, vf = k.float(), v.float()
    out = torch.zeros((BKV, group, Sq, hd), dtype=torch.float32, device=dev)
    for q0 in range(0, Sq, bq):
        q1 = min(q0 + bq, Sq)
        rows = torch.arange(q0, q1, device=dev)[:, None]
        m = torch.full((BKV, group, q1 - q0), NEG_INF, device=dev)
        l = torch.zeros((BKV, group, q1 - q0), device=dev)
        acc = torch.zeros((BKV, group, q1 - q0, hd), device=dev)
        for k0 in range(0, Sk, bk):
            k1 = min(k0 + bk, Sk)
            # tile-level gating: skip wholly masked key tiles
            if causal and k0 > q1 - 1:
                break
            if window > 0 and k1 - 1 <= q0 - window:
                continue
            s = torch.einsum("bgqh,bsh->bgqs", qf[:, :, q0:q1],
                             kf[:, k0:k1]) * scale
            cols = torch.arange(k0, k1, device=dev)[None, :]
            bad = torch.zeros((q1 - q0, k1 - k0), dtype=torch.bool, device=dev)
            if causal:
                bad = bad | (cols > rows)
            if window > 0:
                bad = bad | (cols <= rows - window)
            s = s + torch.where(bad, NEG_INF, 0.0)
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bgqs,bsh->bgqh", p, vf[:, k0:k1])
            m = m_new
        out[:, :, q0:q1] = acc / torch.clamp(l, min=1e-20)[..., None]
    return out.reshape(BH, Sq, hd).to(q.dtype)


@functools.lru_cache(maxsize=None)
def attn_pairs(sq: int, sk: int, causal: bool, window: int) -> int:
    """Live (row, column) pairs of one head's attention: the products a
    kernel that skips every masked column must do."""
    n = 0
    for i in range(sq):
        hi = min(i + 1, sk) if causal else sk
        lo = max(0, i - window + 1) if window > 0 else 0
        n += max(0, hi - lo)
    return n


def cost(q_shape, k_shape, dtype: torch.dtype, *, causal: bool,
         window: int = 0) -> Tuple[float, float]:
    """(FLOPs, bytes) of one launch in the model layout (q (B, Sq, H,
    hd), k and v (B, Sk, KV, hd)): q, k, v read once and the output
    written once; 4 hd per live (row, column) pair and head (Q.K^T and
    P.V)."""
    b, sq, h, d = q_shape
    sk, kv = k_shape[1], k_shape[2]
    nbytes = dtype.itemsize * (2 * b * sq * h * d + 2 * b * sk * kv * d)
    return (float(4 * d * attn_pairs(sq, sk, bool(causal), max(int(window),
                                                               0)) * b * h),
            float(nbytes))


def _lib(route: str):
    fn = getattr(_build.load("flash_attention"), f"flash_attention_{route}_launch")
    if fn.argtypes is None:
        fn.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                       _L, _L, _L, _L, _L, _L, _I, _I, _F, _P]
        fn.restype = _I
    return fn


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           out: torch.Tensor, *, causal: bool, window: int) -> torch.Tensor:
    """Launch the kernel on 4-d views: q and ``out`` (B, Sq, H, hd) with the
    same strides, k and v (B, Sk, KV, hd) with the same strides, hd
    contiguous in all four; f32 or bf16, one dtype, one CUDA device.
    bf16 goes to the tensor-core kernel, f32 to the FMA kernel. Writes
    ``out`` and returns it. Counted, in all and by route."""
    refuse_grad("flash_attention", q, k, v)
    if q.is_meta:
        kernel_launch("flash_attention", lambda: cost(
            q.shape, k.shape, q.dtype, causal=causal, window=window))
        c = launch_counter(_LAUNCHES, "flash_attention")
        c["n"] += 1
        c[_ROUTE.get(q.dtype, "tc")] += 1
        return out
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"kernel launch needs CUDA tensors, got {dev}")
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if t.dtype not in _ROUTE or t.dtype != q.dtype:
            raise TypeError(f"{name} has dtype {t.dtype}; the kernel takes "
                            f"one of {tuple(_ROUTE)} for all four")
        if t.dim() != 4 or t.stride(3) != 1:
            raise ValueError(f"{name} must be 4-d with hd contiguous, got "
                             f"shape {tuple(t.shape)} strides {t.stride()}")
    B, Sq, H, hd = q.shape
    _, Sk, KV, _ = k.shape
    if tuple(out.shape) != tuple(q.shape) or out.stride() != q.stride():
        raise ValueError("out must match q's shape and strides")
    if (tuple(v.shape) != tuple(k.shape) or v.stride() != k.stride()
            or k.shape[0] != B or k.shape[3] != hd):
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"fit q {tuple(q.shape)}")
    if KV < 1 or H % KV or not 1 <= hd <= _MAX_HD or B * H > 65535:
        raise ValueError(f"need heads ({H}) a multiple of KV heads ({KV}), "
                         f"1 <= hd ({hd}) <= {_MAX_HD}, B * H <= 65535")
    route = _ROUTE[q.dtype]
    err = _lib(route)(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), B, H, KV, Sq, Sk, hd, *q.stride()[:3],
                      *k.stride()[:3], int(causal), max(int(window), 0),
                      1.0 / math.sqrt(hd),
                      torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention ({route}) kernel launch failed: "
                           f"CUDA error {err}")
    c = launch_counter(_LAUNCHES, "flash_attention")
    c["n"] += 1
    c[route] += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    group: int = 1, causal: bool = True, window: int = 0,
                    bq: int = 128, bk: int = 128) -> torch.Tensor:
    """q: (BH, Sq, hd); k, v: (BKV, Sk, hd) with BH == BKV * group. ``bq``
    and ``bk`` tile the plain version on the CPU; the kernel ignores them."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, group=group, causal=causal,
                                     window=window, bq=bq, bk=bk)
    BH, Sq, hd = q.shape
    BKV = k.shape[0]
    if BH != BKV * group:
        raise ValueError(f"q has {BH} rows, expected {BKV} x group {group}")
    q = q.contiguous()
    out = torch.empty_like(q)

    def heads(t):  # (BKV * group, Sq, hd) -> (BKV, Sq, group, hd) view
        return t.view(BKV, group, Sq, hd).transpose(1, 2)

    launch(heads(q), k.contiguous()[:, :, None], v.contiguous()[:, :, None],
           heads(out), causal=causal, window=window)
    return out
