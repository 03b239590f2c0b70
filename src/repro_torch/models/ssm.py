"""Mamba2 / SSD (state-space duality) blocks.

Port of ``repro.models.ssm``. The chunked SSD algorithm (arXiv:2405.21060)
splits the linear recurrence into an intra-chunk dense term and an
inter-chunk state recurrence. That algorithm in plain PyTorch,
``ssd_chunked``, lives beside its kernel in ``kernels.ssd_scan`` (and the
sequential ``ssd_reference`` in ``kernels.ref``); both names are imported
here, where the reference has them.

``ssm_forward`` (the prompt pass) reaches the scan through
``kernels.ops.ssd_scan_bshn``: the hand-written CUDA kernel
(``csrc/ssd_scan.cu``) on a card, ``ssd_chunked`` on the CPU. This is the
one place where the port routes a model path through a kernel that the JAX
model path does not call (JAX's ``ssm_forward`` calls ``ssd_chunked``
directly); the kernel computes the same function, and the tests hold it to
``ssd_chunked``. Training differentiates through it: on a card the
backward kernel (``csrc/ssd_scan_bwd.cu``), on the CPU autograd through
``ssd_chunked``.

Projection weights are stored unpacked (``w_x``, ``w_z``, ``w_bc``,
``w_dt``) so width morphing can prefix-slice SSD heads. Where JAX returns a
new cache, ``ssm_decode_step`` writes the conv tails and the state into the
cache views in place, as ``layers.mha_decode`` writes K/V.

Recurrence convention (inclusive decay):
    h_t = exp(dt_t * A) * h_{t-1} + dt_t * B_t (x) x_t
    y_t = C_t . h_t + D * x_t
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.device import dtype_of
from repro_torch.kernels import ops
from repro_torch.kernels.ref import ssd_reference  # noqa: F401 (re-export)
from repro_torch.kernels.ssd_scan import ssd_chunked  # noqa: F401 (re-export)
from repro_torch.models.layers import (apply_norm, apply_norm_masked,
                                       dense_init, matmul, morph_proj)
from repro_torch.parallel import tensor_parallel as TP

def init_ssm(gen: torch.Generator, cfg: ModelConfig, *, lead=(), device=None):
    """Seeded SSM block parameters with the JAX tree keys, shapes and init
    distributions (A in [1, 16), dt in [1e-3, 1e-1] through an inverse
    softplus); ``lead`` prepends the group axis."""
    d, d_in = cfg.d_model, cfg.ssm_d_inner
    nh, g, n, k = cfg.ssm_nheads, cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_conv
    pd = dtype_of(cfg.param_dtype)
    kw = dict(dtype=pd, device=device, lead=lead)
    lead = tuple(lead)

    def uniform(lo, hi):
        u = torch.rand(lead + (nh,), generator=gen, device=device)
        return lo + (hi - lo) * u

    a = uniform(1.0, 16.0)
    dt = torch.exp(uniform(0.0, 1.0) * (math.log(0.1) - math.log(0.001))
                   + math.log(0.001))
    dt_bias = dt + torch.log(-torch.expm1(-dt))  # inverse softplus
    return {
        "w_x": dense_init(gen, (d, d_in), **kw),
        "w_z": dense_init(gen, (d, d_in), **kw),
        "w_bc": dense_init(gen, (d, 2 * g * n), **kw),
        "w_dt": dense_init(gen, (d, nh), **kw),
        "conv_x_w": dense_init(gen, (d_in, k), in_axis=1, **kw),
        "conv_x_b": torch.zeros(lead + (d_in,), dtype=pd, device=device),
        "conv_bc_w": dense_init(gen, (2 * g * n, k), in_axis=1, **kw),
        "conv_bc_b": torch.zeros(lead + (2 * g * n,), dtype=pd,
                                 device=device),
        "A_log": torch.log(a).to(pd),
        "D": torch.ones(lead + (nh,), dtype=pd, device=device),
        "dt_bias": dt_bias.to(pd),
        "ssm_norm": {"scale": torch.ones(lead + (d_in,), dtype=pd,
                                         device=device)},
        "out_proj": dense_init(gen, (d_in, d), **kw),
    }


def _causal_conv(u, w, b, tail: Optional[torch.Tensor] = None):
    """Depthwise causal conv. u: (B, S, C), w: (C, K), b: (C,).

    ``tail`` (B, K-1, C) is prepended (decode / prefill chaining); zeros
    when None. Returns (y, new_tail) with new_tail the last K-1 inputs."""
    B, S, Cc = u.shape
    K = w.shape[1]
    if tail is None:
        tail = torch.zeros((B, K - 1, Cc), dtype=u.dtype, device=u.device)
    xt = torch.cat([tail.to(u.dtype), u], dim=1)  # (B, S+K-1, C)
    # y_t = sum_k w[:, k] * x_{t+k}
    views = torch.stack([xt[:, k:k + S, :] for k in range(K)], dim=-1)
    y = torch.einsum("bsck,ck->bsc", views.float(), w.float())
    y = (y + b.float()).to(u.dtype)
    return y, xt[:, -(K - 1):, :]


def _split_bc(bc, g: int, n: int):
    """(…, 2gn) conv output -> B_, C_ (…, g, n)."""
    lead = tuple(bc.shape[:-1])
    return (bc[..., : g * n].reshape(lead + (g, n)),
            bc[..., g * n:].reshape(lead + (g, n)))


def _gated_out(params, y, z, cfg: ModelConfig, dt_, a_in):
    """Gated RMSNorm (mamba2: norm(y * silu(z))) and the output
    projection, contraction gated at ``a_in`` when given."""
    nh = params["A_log"].shape[0]
    hp = cfg.ssm_head_dim
    y = y * F.silu(z.float())
    norm = {"scale": params["ssm_norm"]["scale"][: nh * hp]}
    if a_in is None and not TP.model_sharded():
        y = apply_norm(norm, y.to(dt_), cfg)
    else:
        # channels split over a mesh's model axis: the mean square spans
        # every rank's channels (``apply_norm_masked`` all-reduces)
        y = apply_norm_masked(norm, y.to(dt_), cfg,
                              y.shape[-1] if a_in is None else a_in)
    return morph_proj(y, params["out_proj"], active_k=a_in)


def ssm_forward(params, x, cfg: ModelConfig, *, return_state: bool = False):
    """Full-sequence mamba2 block from a zero state. x: (B, S, d). Returns
    (y, (conv_tails, state)) with ``return_state``, else (y, None)."""
    dt_ = x.dtype
    nh = params["A_log"].shape[0]
    hp = cfg.ssm_head_dim
    g, n = cfg.ssm_ngroups, cfg.ssm_state
    xs = matmul(x, params["w_x"], dt_)  # (B, S, d_in)
    z = matmul(x, params["w_z"], dt_)
    bc = matmul(x, params["w_bc"], dt_)  # (B, S, 2gn)
    dt_raw = matmul(x, params["w_dt"], dt_)  # (B, S, nh)

    xs, x_tail = _causal_conv(xs, params["conv_x_w"][: nh * hp],
                              params["conv_x_b"][: nh * hp])
    bc, bc_tail = _causal_conv(bc, params["conv_bc_w"], params["conv_bc_b"])
    xs = F.silu(xs.float())
    bc = F.silu(bc.float())
    B_, C_ = _split_bc(bc, g, n)

    dt = F.softplus(dt_raw.float() + params["dt_bias"].float())
    A = -torch.exp(params["A_log"].float())
    xh = xs.reshape(xs.shape[0], xs.shape[1], nh, hp)
    y, final_state = ops.ssd_scan_bshn(xh, dt, A, B_, C_,
                                       chunk=cfg.ssm_chunk)
    y = y + params["D"].float()[:, None] * xh
    y = y.reshape(xs.shape[0], xs.shape[1], nh * hp)
    out = _gated_out(params, y, z, cfg, dt_, None)
    if return_state:
        return out, ((x_tail, bc_tail), final_state.float())
    return out, None


def init_ssm_cache(cfg: ModelConfig, batch: int, dtype=torch.float32, *,
                   lead=(), device=None):
    """Zeroed recurrent cache of one SSM layer: conv tails in ``dtype``,
    the state in f32; ``lead`` prepends the group axis."""
    nh, hp = cfg.ssm_nheads, cfg.ssm_head_dim
    g, n, k = cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_conv
    lead = tuple(lead)
    return {
        "conv_x": torch.zeros(lead + (batch, k - 1, nh * hp), dtype=dtype,
                              device=device),
        "conv_bc": torch.zeros(lead + (batch, k - 1, 2 * g * n), dtype=dtype,
                               device=device),
        "state": torch.zeros(lead + (batch, nh, hp, n), dtype=torch.float32,
                             device=device),
    }


def _projections(params, x, cfg: ModelConfig, active):
    """The decode-path projections: x / z gated at each slot's ``d_inner``,
    dt at its ``ssm_heads``; B/C groups are never width-gated."""
    a_in = active.get("d_inner") if active else None
    xs = morph_proj(x, params["w_x"], active_n=a_in)
    z = morph_proj(x, params["w_z"], active_n=a_in)
    bc = matmul(x, params["w_bc"], x.dtype)
    dt_raw = morph_proj(x, params["w_dt"],
                        active_n=active.get("ssm_heads") if active else None)
    return a_in, xs, z, bc, dt_raw


def ssm_decode_step(params, x, cache, cfg: ModelConfig, active=None):
    """One-token decode. x: (B, 1, d). Returns (y, cache).

    ``active`` (dict with "d_inner"/"ssm_heads", scalars or per-slot (B,))
    runtime-gates the head dimension: the x/z/dt projections zero columns
    beyond each slot's active width, the z-gate multiplies inactive
    channels (which pick up conv bias) back to exact zero, the gated
    RMSNorm divides by the active channel count, and the output
    projection's contraction skips inactive channels. Inactive heads still
    carry (bounded) garbage in ``state``: it is unread, and slot
    re-admission zeroes it. The new conv tails and state are written into
    ``cache`` in place."""
    dt_ = x.dtype
    nh = params["A_log"].shape[0]
    hp = cfg.ssm_head_dim
    g, n = cfg.ssm_ngroups, cfg.ssm_state
    a_in, xs, z, bc, dt_raw = _projections(params, x, cfg, active)

    xs, x_tail = _causal_conv(xs, params["conv_x_w"][: nh * hp],
                              params["conv_x_b"][: nh * hp], cache["conv_x"])
    bc, bc_tail = _causal_conv(bc, params["conv_bc_w"], params["conv_bc_b"],
                               cache["conv_bc"])
    xs = F.silu(xs.float())[:, 0]  # (B, d_in)
    bc = F.silu(bc.float())[:, 0]
    B_, C_ = (t.repeat_interleave(nh // g, dim=1) for t in _split_bc(bc, g, n))
    dt = F.softplus(dt_raw.float()[:, 0] + params["dt_bias"].float())
    A = -torch.exp(params["A_log"].float())
    xh = xs.reshape(-1, nh, hp)

    decay = torch.exp(dt * A)  # (B, h)
    upd = torch.einsum("bhp,bhn->bhpn", xh * dt[..., None], B_)
    state = cache["state"] * decay[..., None, None] + upd
    y = (torch.einsum("bhpn,bhn->bhp", state, C_)
         + params["D"].float()[:, None] * xh)
    out = _gated_out(params, y.reshape(-1, 1, nh * hp), z, cfg, dt_, a_in)
    cache["conv_x"].copy_(x_tail)
    cache["conv_bc"].copy_(bc_tail)
    cache["state"].copy_(state)
    return out, cache


def _conv_step_tails(tail0, u):
    """Per-step conv tails: tails[:, j] = last K-1 inputs after consuming
    u[:, :j+1]. tail0: (B, K-1, C); u: (B, S, C). Returns (B, S, K-1, C)."""
    S = u.shape[1]
    xt = torch.cat([tail0.to(u.dtype), u], dim=1)  # (B, S+K-1, C)
    return torch.stack([xt[:, 1 + o:1 + o + S, :]
                        for o in range(tail0.shape[1])], dim=2)


def ssm_verify_step(params, x, cache, cfg: ModelConfig, active=None):
    """Speculative verify pass: score S positions in one pass.

    Same math as S chained ``ssm_decode_step`` calls (conv chaining off the
    cached tails, sequential state recurrence), but the cache is READ only:
    the per-step recurrent state and conv tails come back stacked over
    positions so ``models.model.commit_verify`` can select the state after
    exactly ``n_accepted + 1`` consumed tokens.

    Returns (y (B, S, d), candidates) with candidates holding per-step
    ``conv_x`` / ``conv_bc`` tails (B, S, K-1, C) and ``state``
    (B, S, nh, hp, n): entry j is the value AFTER consuming token j."""
    dt_ = x.dtype
    B, S, _ = x.shape
    nh = params["A_log"].shape[0]
    hp = cfg.ssm_head_dim
    g, n = cfg.ssm_ngroups, cfg.ssm_state
    a_in, xs, z, bc, dt_raw = _projections(params, x, cfg, active)

    xs_conv, _ = _causal_conv(xs, params["conv_x_w"][: nh * hp],
                              params["conv_x_b"][: nh * hp], cache["conv_x"])
    bc_conv, _ = _causal_conv(bc, params["conv_bc_w"], params["conv_bc_b"],
                              cache["conv_bc"])
    x_tails = _conv_step_tails(cache["conv_x"], xs)
    bc_tails = _conv_step_tails(cache["conv_bc"], bc)

    xs_f = F.silu(xs_conv.float())  # (B, S, d_in)
    bc_f = F.silu(bc_conv.float())
    B_, C_ = (t.repeat_interleave(nh // g, dim=2)
              for t in _split_bc(bc_f, g, n))
    dt = F.softplus(dt_raw.float() + params["dt_bias"].float())  # (B,S,nh)
    A = -torch.exp(params["A_log"].float())
    xh = xs_f.reshape(B, S, nh, hp)

    state = cache["state"]
    ys, states = [], []
    for j in range(S):
        decay = torch.exp(dt[:, j] * A)
        upd = torch.einsum("bhp,bhn->bhpn", xh[:, j] * dt[:, j, :, None],
                           B_[:, j])
        state = state * decay[..., None, None] + upd
        ys.append(torch.einsum("bhpn,bhn->bhp", state, C_[:, j]))
        states.append(state)
    y = torch.stack(ys, dim=1) + params["D"].float()[:, None] * xh
    out = _gated_out(params, y.reshape(B, S, nh * hp), z, cfg, dt_, a_in)
    return out, {"conv_x": x_tails, "conv_bc": bc_tails,
                 "state": torch.stack(states, dim=1)}


def _window_conv(win, w, b, dtype):
    """Depthwise conv of per-node windows: win (B, Q, K, C), w (C, K),
    b (C,) -> (B, Q, C) in ``dtype``."""
    y = torch.einsum("bqkc,ck->bqc", win.float(), w.float())
    return (y + b.float()).to(dtype)


def _path_conv(u, w, b, tail, paths):
    """Per-node causal conv along each tree node's ancestor path.

    u: (B, N, C) per-node conv inputs in tree order; ``paths`` the static
    root-to-node index paths. Node q's window is the last K entries of the
    cached tail (B, K-1, C) followed by the inputs along q's path: what
    ``depth(q) + 1`` chained decode steps down that branch would see.
    Returns (y (B, N, C), tails (B, N, K-1, C) the per-node post-consume
    tails). One gather for all nodes."""
    K = w.shape[1]
    ext = torch.cat([tail.to(u.dtype), u], dim=1)  # tail rows, then nodes
    idx = []
    for path in paths:
        seq = list(range(K - 1)) + [K - 1 + n for n in path]
        idx.append(seq[-K:])  # len(seq) = K-1 + depth+1 >= K always
    idx = torch.tensor(idx, dtype=torch.int64, device=u.device)  # (N, K)
    win = ext[:, idx]  # (B, N, K, C)
    return _window_conv(win, w, b, u.dtype), win[:, :, 1:]


def _softplus(x):
    """softplus(x) = log1p(exp(x)) from exp, log and a division (Kahan's
    log1p; within 3e-7 relative of ``F.softplus``). PyTorch's CPU softplus
    and log1p take a scalar path for a tensor's trailing elements whose last
    bit differs from their vector path, so a row's value would depend on how
    many rows one call scores; these three ops give every element the same
    bits at any size, so a tree node's dt is the same whether its level or
    its whole tree is scored."""
    e = torch.exp(x)
    u = 1.0 + e
    y = torch.where(u == 1.0, e, torch.log(u) * (e / (u - 1.0)))
    return torch.where(x > 20.0, x, y)


def _tree_gate_in(params, x, cfg: ModelConfig, active, conv):
    """The tree passes' shared front half: projections, the per-node conv
    (``conv(u, w, b, cache_key)`` -> (y, tails)), activations and the SSD
    operands. Returns (a_in, z, xh, dt, A, B_, C_, x_tails, bc_tails)."""
    nh = params["A_log"].shape[0]
    hp = cfg.ssm_head_dim
    g, n = cfg.ssm_ngroups, cfg.ssm_state
    B, N, _ = x.shape
    a_in, xs, z, bc, dt_raw = _projections(params, x, cfg, active)
    xs_conv, x_tails = conv(xs, params["conv_x_w"][: nh * hp],
                            params["conv_x_b"][: nh * hp], "conv_x")
    bc_conv, bc_tails = conv(bc, params["conv_bc_w"], params["conv_bc_b"],
                             "conv_bc")
    xs_f = F.silu(xs_conv.float())  # (B, N, d_in)
    bc_f = F.silu(bc_conv.float())
    B_, C_ = (t.repeat_interleave(nh // g, dim=2)
              for t in _split_bc(bc_f, g, n))
    dt = _softplus(dt_raw.float() + params["dt_bias"].float())  # (B,N,nh)
    A = -torch.exp(params["A_log"].float())
    return (a_in, z, xs_f.reshape(B, N, nh, hp), dt, A, B_, C_, x_tails,
            bc_tails)


def _tree_gate_out(params, states, C_, xh, z, cfg: ModelConfig, dt_, a_in):
    """The tree passes' shared back half: y = C.h + D x, gated norm, out."""
    B, N, nh, hp = xh.shape
    ys = torch.einsum("bqhpn,bqhn->bqhp", states, C_)
    y = ys + params["D"].float()[:, None] * xh
    return _gated_out(params, y.reshape(B, N, nh * hp), z, cfg, dt_, a_in)


def ssm_verify_tree(params, x, cache, cfg: ModelConfig, tree, active=None):
    """Token-tree verify pass: score every tree node in one pass.

    The math of chaining ``ssm_decode_step`` down every root-to-leaf branch
    (conv windows and recurrent state both follow the ancestor path, read
    from the committed cache, never written): node q's state is
    ``decay_q * state_parent(q) + upd_q``, the root chaining off
    ``cache["state"]``. The recurrence runs one level at a time, every node
    of a level from its parent's state at once. ``tree`` is the static
    topology (``paths``, ``parents``, ``level_nodes``).

    Returns (y (B, N, d), candidates) with per-node ``conv_x`` / ``conv_bc``
    tails (B, N, K-1, C) and ``state`` (B, N, nh, hp, n): entry q is the
    value after consuming the path ending at node q."""
    def conv(u, w, b, key):
        return _path_conv(u, w, b, cache[key], tree.paths)

    a_in, z, xh, dt, A, B_, C_, x_tails, bc_tails = _tree_gate_in(
        params, x, cfg, active, conv)
    decay = torch.exp(dt * A)  # (B, N, h)
    upd = torch.einsum("bqhp,bqhn->bqhpn", xh * dt[..., None], B_)
    states = torch.empty_like(upd)
    states[:, 0] = cache["state"] * decay[:, 0, :, None, None] + upd[:, 0]
    for level in range(1, tree.n_levels + 1):
        f0, f1 = tree.level_nodes(level)
        par = torch.as_tensor(tree.parents[f0:f1], dtype=torch.int64,
                              device=x.device)
        states[:, f0:f1] = (states[:, par] * decay[:, f0:f1, :, None, None]
                            + upd[:, f0:f1])
    out = _tree_gate_out(params, states, C_, xh, z, cfg, x.dtype, a_in)
    return out, {"conv_x": x_tails, "conv_bc": bc_tails, "state": states}


def ssm_tree_level(params, x, cache, carry, cfg: ModelConfig, *, parents,
                   active=None):
    """One tree-draft LEVEL of the SSM recurrence: each frontier node
    advances one step from its parent's carried state.

    x: (B, nf, d) frontier embeddings; ``carry`` holds the post-consume
    values of processed nodes, ``conv_x`` / ``conv_bc`` tails
    (B, Nc, K-1, C) and ``state`` (B, Nc, nh, hp, n); ``parents`` is the
    static (nf,) carry row of each frontier node's parent (-1: chain off
    the committed ``cache``, the root level). A node's conv window is its
    parent's tail followed by its own input, the last K entries of the path
    window ``_path_conv`` builds, and the state reads the same parent
    state: the frontier rows of ``ssm_verify_tree``.

    Returns (y (B, nf, d), rows) with per-node ``conv_x`` / ``conv_bc``
    tails (B, nf, K-1, C) and ``state`` (B, nf, nh, hp, n), ready to write
    into the carry at the frontier rows."""
    if int(parents[0]) < 0:  # root level: nf == 1, chain off the cache
        par_of = {k: cache[k][:, None] for k in ("conv_x", "conv_bc",
                                                 "state")}
    else:
        pidx = torch.as_tensor(np.asarray(parents), dtype=torch.int64,
                               device=x.device)
        par_of = {k: carry[k][:, pidx] for k in ("conv_x", "conv_bc",
                                                 "state")}

    def conv(u, w, b, key):
        win = torch.cat([par_of[key].to(u.dtype), u[:, :, None, :]], dim=2)
        return _window_conv(win, w, b, u.dtype), win[:, :, 1:]

    a_in, z, xh, dt, A, B_, C_, x_tails, bc_tails = _tree_gate_in(
        params, x, cfg, active, conv)
    decay = torch.exp(dt * A)  # (B, nf, h)
    upd = torch.einsum("bqhp,bqhn->bqhpn", xh * dt[..., None], B_)
    states = par_of["state"].float() * decay[..., None, None] + upd
    out = _tree_gate_out(params, states, C_, xh, z, cfg, x.dtype, a_in)
    return out, {"conv_x": x_tails, "conv_bc": bc_tails, "state": states}
