"""Architecture registry: ``--arch <id>`` lookup + reduced smoke variants."""
from __future__ import annotations

import dataclasses
import math
from typing import Dict

from repro_torch.configs.base import ElasticConfig, ModelConfig

from repro_torch.configs.jamba_v0_1_52b import CONFIG as JAMBA
from repro_torch.configs.whisper_base import CONFIG as WHISPER
from repro_torch.configs.nemotron_4_340b import CONFIG as NEMOTRON
from repro_torch.configs.phi3_medium_14b import CONFIG as PHI3
from repro_torch.configs.tinyllama_1_1b import CONFIG as TINYLLAMA
from repro_torch.configs.deepseek_67b import CONFIG as DEEPSEEK
from repro_torch.configs.mamba2_370m import CONFIG as MAMBA2
from repro_torch.configs.granite_moe_1b_a400m import CONFIG as GRANITE
from repro_torch.configs.mixtral_8x22b import CONFIG as MIXTRAL
from repro_torch.configs.internvl2_2b import CONFIG as INTERNVL

ARCHS: Dict[str, ModelConfig] = {
    cfg.name: cfg
    for cfg in (
        JAMBA, WHISPER, NEMOTRON, PHI3, TINYLLAMA,
        DEEPSEEK, MAMBA2, GRANITE, MIXTRAL, INTERNVL,
    )
}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]


def smoke_config(name: str, *, seed_dims: int = 32) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests.

    Keeps the layer pattern / family structure (hybrid period, MoE routing,
    enc-dec split, frontend stub) while shrinking widths, depths, expert
    counts, and embedding tables.
    """
    cfg = get_config(name)
    d = seed_dims * 2  # d_model 64
    period = cfg.period
    n_groups = max(2, min(3, cfg.n_groups))
    kw = dict(
        name=cfg.name + "-smoke",
        n_layers=period * n_groups,
        d_model=d,
        n_heads=4 if cfg.n_heads else 0,
        n_kv_heads=2 if cfg.n_kv_heads else 0,
        head_dim=16 if cfg.n_heads else 0,
        d_ff=d * 2 if cfg.d_ff else 0,
        vocab_size=512,
        param_dtype="float32",
        dtype="float32",
        elastic=ElasticConfig(
            width_fractions=(0.5, 1.0),  # smoke kv heads = 2: finer slices invalid
            exit_layers=(max(1, n_groups // 2),),
        ),
    )
    if cfg.n_experts:
        kw.update(n_experts=4, top_k=min(2, cfg.top_k), moe_d_ff=d * 2, moe_group_size=64)
    if cfg.ssm_state:
        kw.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=16)
    if cfg.is_encdec:
        kw.update(enc_layers=2, enc_seq=24)
    if cfg.frontend:
        kw.update(frontend_seq=8 if cfg.frontend == "vision_stub" else 24, frontend_dim=48)
    return dataclasses.replace(cfg, **kw)


def list_archs():
    return sorted(ARCHS)
