"""NeuroMorph elastic parameterization: width/depth morphing of a shared net.

Port of ``repro.core.elastic`` (the runtime-operand half). Width morphing
prefix-slices the *inner* dimensions — attention heads, KV heads, MLP hidden
columns — while keeping the d_model residual stream intact; depth morphing
runs the first ``mode.depth`` layer groups, then an exit head. On the
serving path width is data: ``active_widths_batch`` lowers per-slot width
fractions to (B,) int32 device tensors that the kernels read, so a width
switch never rebuilds anything.

For training and per-mode evaluation, ``slice_params`` builds the subnet's
params as prefix *views* of the full tensors (``narrow``), so a student's
gradients land in the shared store through those views: the paper's
``merge(subnet, net)`` is the identity. ``morph_forward`` and
``morph_decode_step`` run the subnet with shapes specialised to its mode;
``morph_decode_step_dynamic`` keeps the full shapes and gates width at
runtime.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from repro_torch.configs.base import ModelConfig, MorphMode


def check_width(cfg: ModelConfig, w: float) -> None:
    if not (0.0 < w <= 1.0):
        raise ValueError(f"width fraction {w} out of (0, 1]")
    for name, v in (("n_heads", cfg.n_heads), ("n_kv_heads", cfg.n_kv_heads)):
        if v and abs(v * w - round(v * w)) > 1e-9:
            raise ValueError(f"{cfg.name}: width {w} does not divide {name}={v}")
    if cfg.ssm_state:
        nh = cfg.ssm_nheads
        if abs(nh * w - round(nh * w)) > 1e-9:
            raise ValueError(f"{cfg.name}: width {w} does not divide ssm heads={nh}")


def morph_config(cfg: ModelConfig, mode: MorphMode) -> ModelConfig:
    """Config of the subnetwork selected by ``mode`` (full weights untouched)."""
    check_width(cfg, mode.width)
    if not (0 < mode.depth <= cfg.n_groups):
        raise ValueError(f"depth {mode.depth} out of (0, {cfg.n_groups}]")
    w = mode.width
    kw: Dict = {}
    if cfg.n_heads:
        kw["n_heads"] = int(round(cfg.n_heads * w))
        kw["n_kv_heads"] = max(1, int(round(cfg.n_kv_heads * w)))
    if cfg.d_ff:
        kw["d_ff"] = int(round(cfg.d_ff * w))
    if cfg.n_experts:
        kw["top_k"] = max(1, int(round(cfg.top_k * w)))
    if cfg.ssm_state:
        nh = int(round(cfg.ssm_nheads * w))
        kw["ssm_d_inner_override"] = nh * cfg.ssm_head_dim
    return cfg.scaled(**kw)


# ---------------------------------------------------------------------------
# param slicing (structural, key-driven)
# ---------------------------------------------------------------------------


def _slice_dim(a, size: int, axis: int):
    """Prefix view of ``a`` along ``axis`` (stacked leaves carry the group
    axis first, which the callers skip)."""
    return a.narrow(axis, 0, size)


def _slice_attn(p, cfg_m: ModelConfig, stacked: bool):
    o = 1 if stacked else 0  # stacked leaves carry a leading group axis
    q, kv = cfg_m.q_dim, cfg_m.kv_dim
    return {
        "wq": _slice_dim(p["wq"], q, o + 1),
        "wk": _slice_dim(p["wk"], kv, o + 1),
        "wv": _slice_dim(p["wv"], kv, o + 1),
        "wo": _slice_dim(p["wo"], q, o + 0),
    }


def _slice_mlp(p, cfg_m: ModelConfig, stacked: bool):
    o = 1 if stacked else 0
    f = cfg_m.d_ff
    out = {"wi": _slice_dim(p["wi"], f, o + 1), "wo": _slice_dim(p["wo"], f, o + 0)}
    if "wg" in p:
        out["wg"] = _slice_dim(p["wg"], f, o + 1)
    return out


def _slice_ssm(p, cfg_m: ModelConfig, stacked: bool):
    o = 1 if stacked else 0
    d_in = cfg_m.ssm_d_inner
    nh = cfg_m.ssm_nheads
    return {
        "w_x": _slice_dim(p["w_x"], d_in, o + 1),
        "w_z": _slice_dim(p["w_z"], d_in, o + 1),
        "w_bc": p["w_bc"],
        "w_dt": _slice_dim(p["w_dt"], nh, o + 1),
        "conv_x_w": _slice_dim(p["conv_x_w"], d_in, o + 0),
        "conv_x_b": _slice_dim(p["conv_x_b"], d_in, o + 0),
        "conv_bc_w": p["conv_bc_w"],
        "conv_bc_b": p["conv_bc_b"],
        "A_log": _slice_dim(p["A_log"], nh, o + 0),
        "D": _slice_dim(p["D"], nh, o + 0),
        "dt_bias": _slice_dim(p["dt_bias"], nh, o + 0),
        "ssm_norm": {"scale": _slice_dim(p["ssm_norm"]["scale"], d_in, o + 0)},
        "out_proj": _slice_dim(p["out_proj"], d_in, o + 0),
    }


def _slice_layer(lp, cfg_m: ModelConfig, stacked: bool):
    out = dict(lp)
    if "attn" in lp:
        out["attn"] = _slice_attn(lp["attn"], cfg_m, stacked)
    if "cross" in lp:
        out["cross"] = _slice_attn(lp["cross"], cfg_m, stacked)
    if "ssm" in lp:
        out["ssm"] = _slice_ssm(lp["ssm"], cfg_m, stacked)
    if "mlp" in lp:
        out["mlp"] = _slice_mlp(lp["mlp"], cfg_m, stacked)
    # moe: weights untouched (top_k reduction happens in routing)
    return out


def slice_params(params, cfg: ModelConfig, mode: MorphMode):
    """Params of ``mode``'s subnet: prefix views of the full tensors, no
    copy; gradients through them reach the full tensors."""
    cfg_m = morph_config(cfg, mode)
    out = dict(params)
    out["stack"] = {
        k: _slice_layer(v, cfg_m, stacked=True) for k, v in params["stack"].items()
    }
    if "encoder" in params:
        # encoder depth is never morphed, but width slicing is safe: the
        # encoder's output contract is d_model
        out["encoder"] = dict(params["encoder"])
        out["encoder"]["stack"] = {
            k: _slice_layer(v, cfg_m, stacked=True)
            for k, v in params["encoder"]["stack"].items()
        }
    return out


def morph_forward(params, batch, cfg: ModelConfig, mode: MorphMode, **kw):
    """Forward through the subnetwork selected by ``mode``."""
    from repro_torch.models.model import forward  # local: avoids a cycle

    cfg_m = morph_config(cfg, mode)
    p = slice_params(params, cfg, mode) if mode.width < 1.0 else params
    return forward(p, batch, cfg_m, depth=mode.depth, **kw)


def morph_decode_step(params, cache, tokens, cfg: ModelConfig, mode: MorphMode):
    """Decode step through the subnetwork selected by ``mode``.

    The cache must have been created for the *morphed* dims (one cache per
    active mode; modes share weights, not KV state)."""
    from repro_torch.models.model import decode_step

    cfg_m = morph_config(cfg, mode)
    p = slice_params(params, cfg, mode) if mode.width < 1.0 else params
    return decode_step(p, cache, tokens, cfg_m, depth=mode.depth)


# ---------------------------------------------------------------------------
# runtime-operand width morphing (one step per depth)
# ---------------------------------------------------------------------------


def active_widths(cfg: ModelConfig, width: float) -> Dict[str, int]:
    """Active inner-dimension sizes for a width fraction — the runtime clock
    gates. These integers feed ``models.model.decode_step(..., active=...)``
    as *dynamic* operands (scalars or per-slot vectors): the executable is
    compiled once per depth, and a width switch is just a different operand
    value, never a recompile."""
    check_width(cfg, width)
    cfg_m = morph_config(cfg, MorphMode(depth=cfg.n_groups, width=width))
    out: Dict[str, int] = {}
    if cfg.n_heads:
        out["q_dim"] = cfg_m.q_dim
        out["kv_dim"] = cfg_m.kv_dim
    if cfg.d_ff:
        out["d_ff"] = cfg_m.d_ff
    if cfg.n_experts:
        out["top_k"] = cfg_m.top_k
    if cfg.ssm_state:
        out["d_inner"] = cfg_m.ssm_d_inner
        out["ssm_heads"] = cfg_m.ssm_nheads
    return out


def active_widths_batch(cfg: ModelConfig, widths: Sequence[float], *,
                        device=None) -> Dict[str, torch.Tensor]:
    """Per-slot active dims: one (B,) int32 tensor per gated dimension, on
    ``device`` (the card unless the caller says otherwise).

    ``widths`` holds one width fraction per batch slot — slots of different
    widths share one decode launch (each kernel row reads its own widths)."""
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    per = [active_widths(cfg, w) for w in widths]
    return {k: torch.tensor([p[k] for p in per], dtype=torch.int32, device=dev)
            for k in per[0]}


def morph_decode_step_dynamic(params, cache, tokens, cfg: ModelConfig,
                              width: float, *, depth: Optional[int] = None):
    """Decode step with width applied as a runtime operand over FULL params
    and a full-width cache (the one-step-per-depth path; contrast with
    ``morph_decode_step``, which specialises shapes per mode)."""
    from repro_torch.models.model import decode_step

    active = active_widths_batch(cfg, [width] * tokens.shape[0],
                                 device=tokens.device)
    return decode_step(params, cache, tokens, cfg, depth=depth, active=active)


def flops_fraction(cfg: ModelConfig, mode: MorphMode) -> float:
    """Active-FLOPs fraction of a mode vs the full model (paper Fig. 11/12)."""
    full = cfg.n_active_params()
    cfg_m = morph_config(cfg, mode)
    # per-group active params scale linearly with depth
    body_full = full - _embed_params(cfg)
    body_m = (cfg_m.n_active_params() - _embed_params(cfg_m)) * mode.depth / cfg.n_groups
    return (body_m + _embed_params(cfg)) / (body_full + _embed_params(cfg))


def _embed_params(cfg: ModelConfig) -> int:
    pc = cfg.param_counts()
    return pc["embed"] + pc["unembed"]
