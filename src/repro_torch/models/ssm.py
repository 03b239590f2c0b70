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

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.device import dtype_of
from repro_torch.kernels import ops
from repro_torch.kernels.ref import ssd_reference  # noqa: F401 (re-export)
from repro_torch.kernels.ssd_scan import ssd_chunked  # noqa: F401 (re-export)
from repro_torch.models.layers import (apply_norm, apply_norm_masked,
                                       dense_init, matmul, morph_proj)

_TREE_SLICE = "arrives with the tree slice of the port"


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
    if a_in is None:
        y = apply_norm(norm, y.to(dt_), cfg)
    else:
        y = apply_norm_masked(norm, y.to(dt_), cfg, a_in)
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


def ssm_verify_tree(*args, **kwargs):
    """Token-tree verify of an SSM layer: arrives with the tree slice of
    the port (``repro.models.ssm.ssm_verify_tree`` is its reference)."""
    raise NotImplementedError(f"ssm_verify_tree {_TREE_SLICE}")


def ssm_tree_level(*args, **kwargs):
    """One tree-draft level of an SSM layer: arrives with the tree slice of
    the port (``repro.models.ssm.ssm_tree_level``)."""
    raise NotImplementedError(f"ssm_tree_level {_TREE_SLICE}")


def _path_conv(*args, **kwargs):
    """Per-node causal conv along a tree path: arrives with the tree slice
    of the port (``repro.models.ssm._path_conv``)."""
    raise NotImplementedError(f"_path_conv {_TREE_SLICE}")
