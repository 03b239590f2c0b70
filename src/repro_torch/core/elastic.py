"""NeuroMorph elastic parameterization: width/depth morphing of a shared net.

Port of ``repro.core.elastic`` (the runtime-operand half). Width morphing
prefix-slices the *inner* dimensions — attention heads, KV heads, MLP hidden
columns — while keeping the d_model residual stream intact; depth morphing
runs the first ``mode.depth`` layer groups, then an exit head. On the
serving path width is data: ``active_widths_batch`` lowers per-slot width
fractions to (B,) int32 device tensors that the kernels read, so a width
switch never rebuilds anything. ``slice_params`` / ``morph_forward`` arrive
with the training slice.
"""
from __future__ import annotations

from typing import Dict, Sequence

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
