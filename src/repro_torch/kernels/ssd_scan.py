"""ssd_scan — the Mamba2 SSD chunked scan.

Port of ``repro.kernels.ssd_scan``. Layout as there: per (batch * head) row,
x (BH, S, hp), dt (BH, S) post-softplus, A (BH,) negative, B and C
(BH, S, n); returns y (BH, S, hp) in x's dtype and the final state
(BH, hp, n) in f32. ``ops.ssd_scan_bshn`` reaches the same kernel in the
model layout, with B and C read per group instead of repeated per head.

``ssd_chunked`` (a port of ``repro.models.ssm.ssd_chunked``) is the
chunked algorithm in plain PyTorch in the model layout; on a CPU tensor
``ssd_scan`` runs ``ssd_scan_plain``, that function on a one-head view. On
CUDA tensors it launches the hand-written kernels in ``csrc/ssd_scan.cu``
or raises: three launches, the products on the tensor cores (3xTF32): the
64-step tiles' state contributions, and C.B^T once per (batch, group,
tile), all tiles in parallel; the carry of the state over the tiles
(elementwise); the outputs of all tiles in parallel. They work in 64-step
tiles and mask a ragged last tile; no argument changes the tiling.
Every chunk size gives the same function up to rounding, so ``chunk``
selects only the plain version's chunking, and is kept for the reference's
signature. ``launch_count()`` counts the scans launched (three kernel
launches each), from either entry point.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_LAUNCHES = {"n": 0}
_MAX_STATE = 256  # kMaxN in csrc/ssd_scan.cu
_P = ctypes.c_void_p
_I = ctypes.c_int


def launch_count() -> int:
    """Scans launched (three kernel launches each) since import / reset."""
    return _LAUNCHES["n"]


def reset_launch_count() -> None:
    _LAUNCHES["n"] = 0


def ssd_chunked(x, dt, A, B_, C_, chunk: int):
    """Chunked SSD scan.

    x: (b, s, h, p) f32; dt: (b, s, h) f32 (post-softplus); A: (h,) f32
    (< 0), or (b, h) for a per-row rate; B_, C_: (b, s, g, n) f32 with g
    dividing h. Returns (y (b, s, h, p), final_state (b, h, p, n)). A
    length that is not a multiple of ``chunk`` is zero-padded: a padded
    step has dt = 0, so it decays by 1 and adds nothing."""
    b, s, h, p = x.shape
    g, n = B_.shape[2], B_.shape[3]
    rep = h // g
    if s % chunk:
        pad = chunk - s % chunk
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B_ = F.pad(B_, (0, 0, 0, 0, 0, pad))
        C_ = F.pad(C_, (0, 0, 0, 0, 0, pad))
    S = x.shape[1]
    nc = S // chunk
    xc = x.reshape(b, nc, chunk, h, p)
    dtc = dt.reshape(b, nc, chunk, h)
    Bh = B_.reshape(b, nc, chunk, g, n).repeat_interleave(rep, dim=3)
    Ch = C_.reshape(b, nc, chunk, g, n).repeat_interleave(rep, dim=3)

    dA = dtc * (A[:, None, None, :] if A.dim() == 2 else A)  # (b,nc,Q,h)
    dA_cs = torch.cumsum(dA, dim=2)  # inclusive

    # intra-chunk: y_q += C_q . sum_{s<=q} exp(dA_cs[q]-dA_cs[s]) dt_s B_s x_s
    CB = torch.einsum("bcqhn,bcshn->bchqs", Ch, Bh)
    t = dA_cs.permute(0, 1, 3, 2)  # (b,nc,h,Q)
    Lm = torch.exp(t[..., :, None] - t[..., None, :])  # (b,nc,h,Q,Q)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=x.device))
    Lm = torch.where(tri, Lm, torch.zeros((), device=x.device))
    u = xc * dtc[..., None]  # (b,nc,Q,h,p)
    y_diag = torch.einsum("bchqs,bcshp->bcqhp", CB * Lm, u)

    # end-of-chunk states: sum_s exp(dA_cs[-1]-dA_cs[s]) dt_s B_s x_s
    decay_states = torch.exp(dA_cs[:, :, -1:, :] - dA_cs)  # (b,nc,Q,h)
    states = torch.einsum("bcqhn,bcqh,bcqhp->bchpn", Bh, decay_states * dtc,
                          xc)

    # inter-chunk recurrence over nc, emitting the state before each chunk
    chunk_decay = torch.exp(dA_cs[:, :, -1, :])  # (b,nc,h)
    h_prev = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    prev = []
    for c in range(nc):
        prev.append(h_prev)
        h_prev = h_prev * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)  # (b,nc,h,p,n)

    # contribution of carried state: y_q += exp(dA_cs[q]) C_q . state_prev
    y_off = torch.einsum("bcqhn,bchpn,bcqh->bcqhp", Ch, prev_states,
                         torch.exp(dA_cs))
    y = (y_diag + y_off).reshape(b, S, h, p)[:, :s]
    return y, h_prev


def ssd_scan_plain(x, dt, A, B, C, *, chunk: int = 128):
    """The kernel's plain PyTorch version in the kernel's layout: the
    chunked algorithm at chunk ``min(chunk, S)``, computed in f32; y in
    x's dtype."""
    S = x.shape[1]
    y, fs = ssd_chunked(x.float()[:, :, None], dt.float()[:, :, None],
                        A.float()[:, None], B.float()[:, :, None],
                        C.float()[:, :, None], max(1, min(chunk, S)))
    return y[:, :, 0].to(x.dtype), fs[:, 0]


def _lib():
    lib = _build.load("ssd_scan")
    fn = lib.ssd_scan_launch
    if fn.argtypes is None:
        fn.argtypes = [_P, _I] + [_P] * 7 + [_I] * 6 + [_P]
        fn.restype = _I
        lib.ssd_scan_workspace.argtypes = [_I] * 6
        lib.ssd_scan_workspace.restype = ctypes.c_longlong
    return lib


def launch_bshn(x: torch.Tensor, dt: torch.Tensor, A_bh: torch.Tensor,
                B: torch.Tensor, C: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernels in the model layout: x (b, s, h, p) f32 or bf16;
    dt (b, s, h), A_bh (b, h), B and C (b, s, g, n), all f32, contiguous
    and on one CUDA device. Returns (y (b, s, h, p) in x's dtype, state
    (b, h, p, n) f32). Counted once."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"kernel launch needs CUDA tensors, got {dev}")
    if x.dim() != 4:
        raise ValueError(f"x must be (b, s, h, p), got {tuple(x.shape)}")
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    want = {"dt": (b, s, h), "A": (b, h), "B": (b, s, g, n),
            "C": (b, s, g, n)}
    for name, t in (("x", x), ("dt", dt), ("A", A_bh), ("B", B), ("C", C)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if name == "x":
            if x.dtype not in _DTYPE_CODE:
                raise TypeError(f"x has dtype {x.dtype}; the kernel takes "
                                f"{tuple(_DTYPE_CODE)}")
            continue
        if t.dtype != torch.float32:
            raise TypeError(f"{name} has dtype {t.dtype}; the kernel takes "
                            f"float32")
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{want[name]}")
    if g < 1 or h % g or not 1 <= n <= _MAX_STATE:
        raise ValueError(f"need heads ({h}) a multiple of groups ({g}) and "
                         f"1 <= n <= {_MAX_STATE}, got n = {n}")
    lib = _lib()
    y = torch.empty_like(x)
    state = torch.empty((b, h, p, n), dtype=torch.float32, device=dev)
    ws = torch.empty(max(1, lib.ssd_scan_workspace(b, s, h, p, g, n)),
                     dtype=torch.float32, device=dev)
    err = lib.ssd_scan_launch(x.data_ptr(), _DTYPE_CODE[x.dtype],
                              dt.data_ptr(), A_bh.data_ptr(), B.data_ptr(),
                              C.data_ptr(), y.data_ptr(), state.data_ptr(),
                              ws.data_ptr(), b, s, h, p, g, n,
                              torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error {err}")
    _LAUNCHES["n"] += 1
    return y, state


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, *, chunk: int = 128
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (BH, S, hp); dt: (BH, S); A: (BH,); B, C: (BH, S, n).
    ``chunk`` selects the plain version's chunking on the CPU (rounding
    only); the kernel ignores it."""
    if chunk < 1:
        raise ValueError(f"chunk must be positive, got {chunk}")
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, A, B, C, chunk=chunk)
    BH = x.shape[0]
    y, fs = launch_bshn(x[:, :, None], dt[:, :, None], A.reshape(BH, 1),
                        B[:, :, None], C[:, :, None])
    return y[:, :, 0], fs[:, 0]
