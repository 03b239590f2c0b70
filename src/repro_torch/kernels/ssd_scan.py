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

The backward (``csrc/ssd_scan_bwd.cu``, a port kernel with no Pallas
counterpart: the reference differentiates ``ssd_chunked`` with XLA) works
on the forward's 64-step tiles and reads the workspace the forward kept
(``ScanFunction``, which ``ops.ssd_scan_bshn`` runs on a card): the
gradient of each tile's state (launch 1), its reverse carry over the tiles
(launch 2), every input's gradient per tile (launch 3) and the sums over a
group's heads (launch 4). ``ssd_scan_bwd_plain`` is its plain version; on
the CPU the model differentiates ``ssd_chunked`` with autograd.
``bwd_launch_count()`` counts the backward scans. ``cost`` and
``bwd_cost`` give one scan's work, forward and backward.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build, launch_counter, refuse_grad
from repro_torch.launch.op_analysis import kernel_launch

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_LAUNCHES = {"n": 0, "bwd": 0}
_MAX_STATE = 256  # kMaxN in csrc/ssd_scan.cu
_TILE = 64  # kL in csrc/ssd_scan.cu and csrc/ssd_scan_bwd.cu
_P = ctypes.c_void_p
_I = ctypes.c_int


def launch_count() -> int:
    """Scans launched (three kernel launches each) since import / reset."""
    return _LAUNCHES["n"]


def bwd_launch_count() -> int:
    """Backward scans launched (four kernel launches each)."""
    return _LAUNCHES["bwd"]


def reset_launch_count() -> None:
    """Zero both counts, forward and backward."""
    _LAUNCHES["n"] = _LAUNCHES["bwd"] = 0


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
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=x.device))
    # masked before exp: above the diagonal the exponent is positive and
    # overflows once a chunk's decay passes ~88, and 0 * inf would make the
    # gradient NaN
    Lm = torch.exp(torch.where(tri, t[..., :, None] - t[..., None, :],
                               float("-inf")))  # (b,nc,h,Q,Q)
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


def scan_ops(s: int, h: int, p: int, n: int, tile: int) -> int:
    """f32 operations of one batch row's scan carried every ``tile``
    steps: per tile of q steps and head, the lower triangle of C.B^T
    (q(q+1)n), its decayed product with dt.x (q(q+1)p), the carried-state
    term and the state update (2qnp each) and the state's decay (pn)."""
    def one(q):
        return q * (q + 1) * (n + p) + 4 * q * n * p + p * n

    r = s % tile
    return h * ((s // tile) * one(tile) + (one(r) if r else 0))


def scan_bwd_ops(s: int, h: int, p: int, n: int, tile: int) -> int:
    """f32 operations of one batch row's backward scan carried every
    ``tile`` steps, counted as ``scan_ops`` counts the forward's: the lower
    triangles of C.B^T and dY.U^T (q(q+1)(n + p)), the in-tile products
    into du, dB and dC (q(q+1)(p + 2n)), the four products with a state
    (8qnp) and the carry (2pn)."""
    def one(q):
        return q * (q + 1) * (3 * n + 2 * p) + 8 * q * n * p + 2 * p * n

    r = s % tile
    return h * ((s // tile) * one(tile) + (one(r) if r else 0))


@functools.lru_cache(maxsize=None)
def least_ops(fn, s: int, h: int, p: int, n: int) -> Tuple[int, int]:
    """(ops, tile): the least of ``fn``'s operations over every tile length
    and its tile (the same function at any tile up to rounding, so the
    cheapest counts)."""
    return min((fn(s, h, p, n, q), q) for q in range(1, s + 1))


def cost(b: int, s: int, h: int, p: int, g: int, n: int,
         x_dtype: torch.dtype = torch.float32) -> Tuple[float, float]:
    """(FLOPs, bytes) of one scan in the model layout: the least f32
    work of the function over every tile length; x, dt, A, B and C read
    once, y and the final state written once."""
    nbytes = (2 * x_dtype.itemsize * b * s * h * p
              + 4 * (b * s * h + h + 2 * b * s * g * n + b * h * p * n))
    return float(b * least_ops(scan_ops, s, h, p, n)[0]), float(nbytes)


def bwd_cost(b: int, s: int, h: int, p: int, g: int, n: int,
             x_dtype: torch.dtype = torch.float32) -> Tuple[float, float]:
    """(FLOPs, bytes) of one backward scan: the least f32 work over
    every tile length; x, dy, dt, A, B, C and the final state's gradient
    read once, dx, ddt, dA, dB and dC written once."""
    nbytes = (3 * x_dtype.itemsize * b * s * h * p
              + 4 * (2 * b * s * h + 2 * h + 4 * b * s * g * n
                     + b * h * p * n))
    return float(b * least_ops(scan_bwd_ops, s, h, p, n)[0]), float(nbytes)


def _workspace(b: int, s: int, h: int, p: int, g: int, n: int,
               bwd: bool) -> int:
    """Floats of the kernels' workspaces (``ssd_scan_workspace`` and
    ``ssd_scan_bwd_workspace`` in the CUDA sources), for a meta launch."""
    t = (s + _TILE - 1) // _TILE
    if bwd:
        return b * h * t * p * n + 2 * b * s * h * n + b * h * t
    return b * h * t * p * n + b * g * t * _TILE * _TILE + b * h * t


def _lib():
    lib = _build.load("ssd_scan")
    fn = lib.ssd_scan_launch
    if fn.argtypes is None:
        fn.argtypes = [_P, _I] + [_P] * 7 + [_I] * 6 + [_P]
        fn.restype = _I
        lib.ssd_scan_workspace.argtypes = [_I] * 6
        lib.ssd_scan_workspace.restype = ctypes.c_longlong
    return lib


def _check_operands(x, dt, A_bh, B, C, extra=()):
    """Device, dtype, shape and contiguity of the scan's model-layout
    operands (and of ``extra``: (name, tensor, shape, dtype or None for
    x's dtype)). Returns (b, s, h, p, g, n)."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"kernel launch needs CUDA tensors, got {dev}")
    if x.dim() != 4:
        raise ValueError(f"x must be (b, s, h, p), got {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"x has dtype {x.dtype}; the kernel takes "
                        f"{tuple(_DTYPE_CODE)}")
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    ops = [("x", x, (b, s, h, p), x.dtype),
           ("dt", dt, (b, s, h), torch.float32),
           ("A", A_bh, (b, h), torch.float32),
           ("B", B, (b, s, g, n), torch.float32),
           ("C", C, (b, s, g, n), torch.float32)]
    for name, t, shape, dtype in ops + [(nm, t, sh, dty or x.dtype)
                                        for nm, t, sh, dty in extra]:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.dtype != dtype:
            raise TypeError(f"{name} has dtype {t.dtype}; the kernel takes "
                            f"{dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{shape}")
    if g < 1 or h % g or not 1 <= n <= _MAX_STATE:
        raise ValueError(f"need heads ({h}) a multiple of groups ({g}) and "
                         f"1 <= n <= {_MAX_STATE}, got n = {n}")
    return b, s, h, p, g, n


def launch_bshn(x: torch.Tensor, dt: torch.Tensor, A_bh: torch.Tensor,
                B: torch.Tensor, C: torch.Tensor, *, keep_workspace=False):
    """Launch the kernels in the model layout: x (b, s, h, p) f32 or bf16;
    dt (b, s, h), A_bh (b, h), B and C (b, s, g, n), all f32, contiguous
    and on one CUDA device. Returns (y (b, s, h, p) in x's dtype, state
    (b, h, p, n) f32), and with ``keep_workspace`` the workspace too: it
    then holds the state before each 64-step tile, C.B^T per (batch, group,
    tile) and each tile's decay, which the backward reads. Counted once."""
    refuse_grad("ssd_scan.launch_bshn (differentiate through "
                "ops.ssd_scan_bshn, whose autograd Function runs the "
                "backward kernel)", x, dt, A_bh, B, C)
    if x.is_meta:
        b, s, h, p = x.shape
        g, n = B.shape[2], B.shape[3]
        kernel_launch("ssd_scan", lambda: cost(b, s, h, p, g, n, x.dtype))
        launch_counter(_LAUNCHES, "ssd_scan")["n"] += 1
        y = torch.empty_like(x)
        state = x.new_empty((b, h, p, n), dtype=torch.float32)
        ws = x.new_empty((max(1, _workspace(b, s, h, p, g, n, False)),),
                         dtype=torch.float32)
        return (y, state, ws) if keep_workspace else (y, state)
    b, s, h, p, g, n = _check_operands(x, dt, A_bh, B, C)
    dev = x.device
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
    launch_counter(_LAUNCHES, "ssd_scan")["n"] += 1
    return (y, state, ws) if keep_workspace else (y, state)


# ---------------------------------------------------------------------------
# the backward
# ---------------------------------------------------------------------------


def ssd_scan_bwd_plain(x, dt, A_bh, B_, C_, dy, dstate=None, *,
                       tile: int = 64):
    """The backward kernel's plain PyTorch version, in the model layout:
    the same tile algorithm, every exponent masked to <= 0 before ``exp``.

    x, dy: (b, s, h, p); dt: (b, s, h); A_bh: (b, h); B_, C_: (b, s, g, n);
    dstate: (b, h, p, n) or None (zero), the gradient into the final state.
    Returns (dx in x's dtype, ddt, dA_bh, dB, dC) in f32. Per tile, with cs
    the inclusive cumsum of a = dt A, u = dt x, h_prev the state before the
    tile and G the gradient into the state after it:
    du_s = sum_{t>=s} M_ts (C_t.B_s) dy_t + w_s G B_s,
    dB_s = sum_{t>=s} M_ts (dy_t.u_s) C_t + w_s G^T u_s,
    dC_t = sum_{s<=t} M_ts (dy_t.u_s) B_s + e_t h_prev^T dy_t,
    G_prev = E G + sum_t e_t dy_t (x) C_t, with M_ts = exp(cs_t - cs_s),
    w_s = exp(cs_last - cs_s), e_t = exp(cs_t), E = exp(cs_last); the
    decay gradient dcs is reverse-summed into da, then ddt = A da + <du, x>,
    dx = dt du, dA = sum dt da. B and C are shared per group, so dB and dC
    sum over the group's heads."""
    b, s, h, p = x.shape
    g, n = B_.shape[2], B_.shape[3]
    rep = h // g
    L = tile
    pad = (-s) % L
    f = torch.float32

    def padded(t):
        t = t.to(f)
        return F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad)) if pad else t

    xf, dtf, Bf, Cf, dyf = (padded(t) for t in (x, dt, B_, C_, dy))
    T = (s + pad) // L
    xc = xf.reshape(b, T, L, h, p)
    dyc = dyf.reshape(b, T, L, h, p)
    dtc = dtf.reshape(b, T, L, h)
    Bh = Bf.reshape(b, T, L, g, n).repeat_interleave(rep, dim=3)
    Ch = Cf.reshape(b, T, L, g, n).repeat_interleave(rep, dim=3)
    A = A_bh.to(f)
    cs = torch.cumsum(dtc * A[:, None, None, :], dim=2)  # (b,T,L,h)
    cs_last = cs[:, :, -1]  # (b,T,h)
    e = torch.exp(cs)
    w = torch.exp(cs_last[:, :, None] - cs)
    E = torch.exp(cs_last)
    u = xc * dtc[..., None]
    # the states before each tile, then the reverse carry of the gradient
    contrib = torch.einsum("bclhn,bclh,bclhp->bchpn", Bh, w, u)
    carry = torch.einsum("bclh,bclhp,bclhn->bchpn", e, dyc, Ch)
    hs, gs = [], [None] * T
    st = torch.zeros((b, h, p, n), dtype=f, device=x.device)
    for c in range(T):
        hs.append(st)
        st = st * E[:, c, :, None, None] + contrib[:, c]
    gr = (torch.zeros((b, h, p, n), dtype=f, device=x.device)
          if dstate is None else dstate.to(f))
    for c in reversed(range(T)):
        gs[c] = gr
        gr = gr * E[:, c, :, None, None] + carry[:, c]
    Hp = torch.stack(hs, dim=1)  # (b,T,h,p,n)
    Gc = torch.stack(gs, dim=1)
    # the tile's own terms, M_ts for s <= t only
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))
    cst = cs.permute(0, 1, 3, 2)  # (b,T,h,L)
    M = torch.exp(torch.where(tri, cst[..., :, None] - cst[..., None, :],
                              float("-inf")))  # (b,T,h,t,s)
    CB = torch.einsum("bcthn,bcshn->bchts", Ch, Bh)
    D = torch.einsum("bcthp,bcshp->bchts", dyc, u)
    P, Q = M * CB, M * D
    GB = torch.einsum("bcshn,bchpn->bcshp", Bh, Gc)  # G B_s
    du = torch.einsum("bchts,bcthp->bcshp", P, dyc) + w[..., None] * GB
    dBh = (torch.einsum("bchts,bcthn->bcshn", Q, Ch)
           + w[..., None] * torch.einsum("bcshp,bchpn->bcshn", u, Gc))
    dYH = torch.einsum("bcthp,bchpn->bcthn", dyc, Hp)
    dCh = torch.einsum("bchts,bcshn->bcthn", Q, Bh) + e[..., None] * dYH
    # the decay gradient: d/dcs of every exp above
    V = Q * CB
    dcs = (V.sum(-1) - V.sum(-2)).permute(0, 1, 3, 2)  # (b,T,L,h)
    dcs = dcs + e * (Ch * dYH).sum(-1)
    z = w * (u * GB).sum(-1)  # (b,T,L,h)
    dcs = dcs - z
    last = z.sum(2) + E * (Gc * Hp).sum((-1, -2))  # (b,T,h)
    dcs = torch.cat([dcs[:, :, :-1], dcs[:, :, -1:] + last[:, :, None]], 2)
    da = torch.flip(torch.cumsum(torch.flip(dcs, [2]), 2), [2])
    ddt = A[:, None, None, :] * da + (du * xc).sum(-1)
    dx = dtc[..., None] * du
    dA = (dtc * da).sum((1, 2))
    dB = dBh.reshape(b, T, L, g, rep, n).sum(4)
    dC = dCh.reshape(b, T, L, g, rep, n).sum(4)
    S = T * L
    return (dx.reshape(b, S, h, p)[:, :s].to(x.dtype),
            ddt.reshape(b, S, h)[:, :s], dA,
            dB.reshape(b, S, g, n)[:, :s], dC.reshape(b, S, g, n)[:, :s])


def _bwd_lib():
    lib = _build.load("ssd_scan_bwd")
    fn = lib.ssd_scan_bwd_launch
    if fn.argtypes is None:
        fn.argtypes = [_P, _I] + [_P] * 13 + [_I] * 6 + [_P]
        fn.restype = _I
        lib.ssd_scan_bwd_workspace.argtypes = [_I] * 6
        lib.ssd_scan_bwd_workspace.restype = ctypes.c_longlong
    return lib


def launch_bwd(x, dt, A_bh, B, C, fws, dy, dstate):
    """Launch the backward kernels (``csrc/ssd_scan_bwd.cu``) on the
    forward's operands and its kept workspace ``fws``; dy (b, s, h, p) in
    x's dtype, dstate (b, h, p, n) f32, all contiguous. Returns (dx in x's
    dtype, ddt, dA_bh, dB, dC) f32. Counted once in ``bwd_launch_count``."""
    b, s, h, p = x.shape
    if x.is_meta:
        g, n = B.shape[2], B.shape[3]
        kernel_launch("ssd_scan_bwd", lambda: bwd_cost(b, s, h, p, g, n,
                                                       x.dtype))
        launch_counter(_LAUNCHES, "ssd_scan")["bwd"] += 1
        x.new_empty((max(1, _workspace(b, s, h, p, g, n, True)),),
                    dtype=torch.float32)
        return (torch.empty_like(x), torch.empty_like(dt),
                torch.empty_like(A_bh), torch.empty_like(B),
                torch.empty_like(C))
    b, s, h, p, g, n = _check_operands(
        x, dt, A_bh, B, C,
        extra=(("dy", dy, (b, s, h, p), None),
               ("dstate", dstate, (b, h, p, B.shape[3]), torch.float32)))
    dev = x.device
    lib = _bwd_lib()
    dx = torch.empty_like(x)
    ddt = torch.empty_like(dt)
    dA = torch.empty_like(A_bh)
    dB = torch.empty_like(B)
    dC = torch.empty_like(C)
    ws = torch.empty(max(1, lib.ssd_scan_bwd_workspace(b, s, h, p, g, n)),
                     dtype=torch.float32, device=dev)
    err = lib.ssd_scan_bwd_launch(
        x.data_ptr(), _DTYPE_CODE[x.dtype], dt.data_ptr(), A_bh.data_ptr(),
        B.data_ptr(), C.data_ptr(), fws.data_ptr(), dy.data_ptr(),
        dstate.data_ptr(), dx.data_ptr(), ddt.data_ptr(), dA.data_ptr(),
        dB.data_ptr(), dC.data_ptr(), ws.data_ptr(), b, s, h, p, g, n,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan backward kernel launch failed: CUDA "
                           f"error {err}")
    launch_counter(_LAUNCHES, "ssd_scan")["bwd"] += 1
    return dx, ddt, dA, dB, dC


class ScanFunction(torch.autograd.Function):
    """The scan on a card, differentiable: the forward kernel keeps its
    workspace (the state before each tile, C.B^T, the tiles' decays), and
    the backward kernel reads it, so nothing is recomputed. Gradients for
    x, dt, A_bh, B and C; the final state's gradient starts the reverse
    carry (zero when the state is unused)."""

    @staticmethod
    def forward(ctx, x, dt, A_bh, B, C):
        with torch.no_grad():
            y, state, ws = launch_bshn(x, dt, A_bh, B, C,
                                       keep_workspace=True)
        ctx.save_for_backward(x, dt, A_bh, B, C, ws)
        return y, state

    @staticmethod
    def backward(ctx, dy, dstate):
        x, dt, A_bh, B, C, ws = ctx.saved_tensors
        return launch_bwd(x, dt, A_bh, B, C, ws, dy.contiguous(),
                          dstate.float().contiguous())


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
