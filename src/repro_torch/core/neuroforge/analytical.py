"""Analytical performance/resource models (paper Eq. 1-15 analogues).

The FPGA paper estimates latency (Eq. 4/10/12/13) and resources (Eq. 11/14/15
+ Table I) per candidate mapping without synthesis. Here we estimate, per
(arch x shape-cell x DesignPoint):

  * FLOPs            — matmul-accurate (2MKN per einsum), attention/SSD terms
  * HBM traffic      — operand+result bytes per op (matches the definition
                       ``compiled.cost_analysis()['bytes accessed']`` uses,
                       so the Fig.-10-style validation is apples-to-apples)
  * collective bytes — ring-cost model per collective op on the mesh
  * HBM capacity     — params + grads + moments + activation working set

and derive the three roofline terms:
    compute_s   = FLOPs / (chips * peak)
    memory_s    = traffic / (chips * hbm_bw)
    collective_s= coll_bytes_per_chip / ici_bw
    latency_est = max(three)            (perfect-overlap lower bound)

All quantities are *global* unless suffixed _per_chip.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional

from repro_torch.configs.base import ModelConfig, ShapeCell
from repro_torch.core.neuroforge.hw import DEFAULT_HW, HardwareSpec, dtype_bytes
from repro_torch.core.neuroforge.space import DesignPoint


@dataclass
class CostReport:
    flops: float  # global FLOPs per step
    hbm_traffic: float  # global bytes moved per step
    coll_bytes_per_chip: float
    hbm_capacity_per_chip: float
    compute_s: float
    memory_s: float
    collective_s: float
    latency_s: float
    model_flops: float  # 6*N*D train / 2*N*tokens inference (active params)
    fits: bool
    detail: Dict[str, float] = dataclasses.field(default_factory=dict)
    hw: HardwareSpec = DEFAULT_HW  # the spec estimate() was called with

    @property
    def bound(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def roofline_fraction(self) -> float:
        """MODEL_FLOPS-ideal time over the dominant term (MFU-style score)."""
        n_chips = self.flops / max(self.compute_s, 1e-30) / self.hw.peak_flops
        ideal = self.model_flops / (n_chips * self.hw.peak_flops)
        return ideal / max(self.latency_s, 1e-30)


def _matmul(M: float, K: float, N: float, b: int) -> Dict[str, float]:
    return {"flops": 2.0 * M * K * N, "bytes": float(b) * (M * K + K * N + M * N)}


def _acc(total: Dict[str, float], item: Dict[str, float], scale: float = 1.0):
    total["flops"] += item["flops"] * scale
    total["bytes"] += item["bytes"] * scale


def forward_costs(cfg: ModelConfig, tokens: int, seq: int, *, act_bytes: int = 2,
                  param_bytes: int = 2, kv_len: Optional[int] = None,
                  decode: bool = False) -> Dict[str, float]:
    """Global forward FLOPs/bytes for `tokens` total tokens at context `seq`.

    ``decode`` models one-token steps against a cache of length kv_len.
    """
    d = cfg.d_model
    t = {"flops": 0.0, "bytes": 0.0}
    n_batch = tokens // max(seq, 1) if not decode else tokens  # sequences
    for i in range(cfg.n_layers):
        kind = cfg.layer_kind(i)
        if kind == "attn":
            _acc(t, _matmul(tokens, d, cfg.q_dim, act_bytes))
            _acc(t, _matmul(tokens, d, 2 * cfg.kv_dim, act_bytes))
            _acc(t, _matmul(tokens, cfg.q_dim, d, act_bytes))
            s_kv = kv_len if decode else seq
            if cfg.sliding_window:
                s_kv = min(s_kv, cfg.sliding_window)
            s_eff = s_kv if decode else (s_kv + 1) / 2.0  # causal average
            # scores + AV
            t["flops"] += 2 * 2.0 * tokens * s_eff * cfg.q_dim
            # softmax + masking + rope elementwise (~8 passes over the score
            # matrix + 4 over q/k): dominates decode FLOPs where matmuls are
            # B-sized
            t["flops"] += 8.0 * tokens * cfg.n_heads * s_eff + 4.0 * tokens * cfg.q_dim
            t["bytes"] += act_bytes * (2 * tokens * cfg.q_dim +
                                       2 * n_batch * s_kv * cfg.kv_dim +
                                       2 * tokens * min(s_kv, cfg.attn_chunk))
        else:
            d_in, n, nh = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_nheads
            g = cfg.ssm_ngroups
            proj_out = 2 * d_in + 2 * g * n + nh
            _acc(t, _matmul(tokens, d, proj_out, act_bytes))
            _acc(t, _matmul(tokens, d_in, d, act_bytes))
            Q = 1 if decode else cfg.ssm_chunk
            # SSD chunk algebra per token: CB (Q*n), L*u (Q*hp), state io (4*hp*n)
            hp = cfg.ssm_head_dim
            t["flops"] += 2.0 * tokens * nh * (Q * n + Q * hp + 2 * hp * n)
            t["bytes"] += act_bytes * tokens * (2 * d_in + 2 * g * n) * 2
        if cfg.layer_is_moe(i):
            f = cfg.moe_d_ff
            k = cfg.top_k
            n_mm = 3 if cfg.activation == "swiglu" else 2
            if decode:
                # dense dropless decode: all experts touched (weights traffic),
                # FLOPs for all experts (tiny vs memory)
                _acc(t, _matmul(tokens, d, f * n_mm * cfg.n_experts / 2, act_bytes))
                t["bytes"] += param_bytes * cfg.n_experts * n_mm * d * f
            else:
                cap_tokens = tokens * k * cfg.capacity_factor
                for _ in range(n_mm):
                    _acc(t, _matmul(cap_tokens, d, f, act_bytes))
                # dispatch/combine einsums ~ 2 * tokens * E * cap_per_group * d
                t["flops"] += 4.0 * tokens * d * k * cfg.capacity_factor
            _acc(t, _matmul(tokens, d, cfg.n_experts, 4))
        elif cfg.d_ff:
            n_mm = 3 if cfg.activation == "swiglu" else 2
            for _ in range(n_mm):
                _acc(t, _matmul(tokens, d, cfg.d_ff, act_bytes))
        # norms / residuals / elementwise: ~6 tensor r/w per layer in f32
        t["bytes"] += 6.0 * tokens * d * 4
        t["flops"] += 12.0 * tokens * d  # norm/residual/activation elementwise
    # embed + unembed
    t["bytes"] += act_bytes * tokens * d + 4 * tokens  # gather
    _acc(t, _matmul(tokens, d, cfg.padded_vocab(), act_bytes))
    if cfg.is_encdec and not decode:
        enc_tokens = n_batch * cfg.enc_seq
        enc_cfg = cfg.scaled(layer_pattern=("attn",), n_layers=cfg.enc_layers,
                             n_experts=0, top_k=0, enc_layers=0)
        enc = forward_costs(enc_cfg, int(enc_tokens), cfg.enc_seq,
                            act_bytes=act_bytes, param_bytes=param_bytes)
        # encoder has no unembed: subtract it back out
        unemb = _matmul(enc_tokens, d, enc_cfg.padded_vocab(), act_bytes)
        t["flops"] += enc["flops"] - unemb["flops"]
        t["bytes"] += enc["bytes"] - unemb["bytes"]
        # cross attention per decoder layer
        for _ in range(cfg.n_layers):
            _acc(t, _matmul(tokens, d, cfg.q_dim, act_bytes))
            _acc(t, _matmul(enc_tokens, d, 2 * cfg.kv_dim, act_bytes))
            _acc(t, _matmul(tokens, cfg.q_dim, d, act_bytes))
            t["flops"] += 2 * 2.0 * tokens * cfg.enc_seq * cfg.q_dim
    return t


def _param_bytes(cfg: ModelConfig, dtype_b: int) -> float:
    return float(cfg.n_params()) * dtype_b


def kv_cache_bytes(cfg: ModelConfig, batch: int, seq: int, *, quant: bool) -> float:
    per_elem = 1 if quant else 2
    total = 0.0
    for i in range(cfg.n_layers):
        if cfg.layer_kind(i) == "attn":
            s = min(seq, cfg.sliding_window) if cfg.sliding_window else seq
            total += 2.0 * batch * s * cfg.kv_dim * per_elem
            if quant:
                total += 2.0 * batch * s * cfg.n_kv_heads * 2  # scales
        else:
            total += batch * (cfg.ssm_nheads * cfg.ssm_head_dim * cfg.ssm_state * 4 +
                              (cfg.ssm_conv - 1) * (cfg.ssm_d_inner +
                                                    2 * cfg.ssm_ngroups * cfg.ssm_state) * 2)
        if cfg.is_encdec:
            total += 2.0 * batch * cfg.enc_seq * cfg.kv_dim * 2
    return total


def estimate(cfg: ModelConfig, cell: ShapeCell, pt: DesignPoint,
             hw: HardwareSpec = DEFAULT_HW, n_pods: int = 1) -> CostReport:
    """Full analytical estimate for one design point on `n_pods` pods."""
    from repro_torch.core import elastic as _el  # late import (cycle)

    chips = pt.dp * pt.tp * n_pods
    width_cfg = cfg
    if pt.width < 1.0:
        width_cfg = _el.morph_config(cfg, dataclasses.replace(
            _mode_stub, depth=cfg.n_groups, width=pt.width))
    c = width_cfg.scaled(capacity_factor=pt.capacity_factor, attn_chunk=pt.attn_chunk)

    pbytes = dtype_bytes(pt.param_dtype)
    abytes = 2  # bf16 activations
    tokens = cell.global_batch * cell.seq_len
    detail: Dict[str, float] = {}

    if cell.kind == "train":
        fwd = forward_costs(c, tokens, cell.seq_len, act_bytes=abytes, param_bytes=pbytes)
        remat_extra = {"none": 0.0, "dots": 0.6, "full": 1.0}[pt.remat]
        flops = fwd["flops"] * (3.0 + remat_extra)  # bwd = 2x fwd (+ recompute)
        traffic = fwd["bytes"] * (3.0 + remat_extra)
        # optimizer update: read p,m,v + write p,m,v (+grad read)
        n_params = c.n_params()
        mom_b = dtype_bytes(pt.moment_dtype)
        traffic += n_params * (2 * pbytes + 4 * mom_b + 2)
        # collectives per chip:
        per_shard_tokens = tokens / max(pt.dp * n_pods, 1)
        ring = lambda n: (n - 1) / max(n, 1)
        # TP: 4 activation all-reduces per layer (fwd 2 + bwd 2), SP-sized
        tp_coll = 4.0 * c.n_layers * per_shard_tokens * c.d_model * abytes * 2 * ring(pt.tp) \
            if pt.tp > 1 else 0.0
        # FSDP gather (fwd+bwd) across dp, re-gathered every microbatch
        dp_world = pt.dp * n_pods
        fsdp = 2.0 * (n_params * pbytes / pt.tp) * ring(dp_world) \
            * max(pt.microbatches, 1) if dp_world > 1 else 0.0
        # gradient reduction across dp
        gb = {"allreduce": 2.0, "reduce_scatter": 1.0, "int8": 0.5}[pt.grad_comm]
        gred = gb * (n_params * pbytes / pt.tp) * ring(dp_world) if dp_world > 1 else 0.0
        # MoE all-to-all (fwd+bwd x dispatch+combine), only under EP sharding
        moe_coll = 0.0
        if c.n_experts and c.n_experts % pt.tp == 0:
            moe_layers = sum(c.layer_is_moe(i) for i in range(c.n_layers))
            moe_coll = 4.0 * moe_layers * per_shard_tokens * c.d_model * abytes * c.top_k
        coll = tp_coll + fsdp + gred + moe_coll  # per-chip bytes
        detail.update(tp_coll=tp_coll, fsdp=fsdp, gred=gred, moe_coll=moe_coll)
        # capacity
        mb_tokens = per_shard_tokens / max(pt.microbatches, 1)
        act_factor = {"none": 12.0, "dots": 4.0, "full": 1.0}[pt.remat]
        act_cap = mb_tokens * c.d_model * abytes * c.n_layers * act_factor / pt.tp
        cap = (n_params * (pbytes + pbytes + 2 * mom_b)) / (pt.dp * pt.tp) + act_cap \
            + tokens / (pt.dp * n_pods) * c.padded_vocab() * 4 / pt.tp  # logits buffer
        model_flops = 6.0 * c.n_active_params() * tokens
    else:
        decode = cell.kind == "decode"
        if decode:
            step_tokens = cell.global_batch  # one token per sequence
            fwd = forward_costs(c, step_tokens, 1, act_bytes=abytes,
                                param_bytes=pbytes, kv_len=cell.seq_len, decode=True)
            kvb = kv_cache_bytes(c, cell.global_batch, cell.seq_len, quant=pt.kv_quant)
            traffic = fwd["bytes"] + kvb + c.n_params() * pbytes  # stream weights + cache
            flops = fwd["flops"]
            coll = 4.0 * c.n_layers * cell.global_batch * c.d_model * abytes \
                * (pt.tp - 1) / max(pt.tp, 1)
            cap = c.n_params() * pbytes / chips + kvb / chips
            model_flops = 2.0 * c.n_active_params() * step_tokens
        else:  # prefill
            fwd = forward_costs(c, tokens, cell.seq_len, act_bytes=abytes,
                                param_bytes=pbytes)
            flops, traffic = fwd["flops"], fwd["bytes"]
            kvb = kv_cache_bytes(c, cell.global_batch, cell.seq_len, quant=pt.kv_quant)
            traffic += kvb
            ring = lambda n: (n - 1) / max(n, 1)
            coll = 2.0 * c.n_layers * (tokens / max(pt.dp * n_pods, 1)) * c.d_model \
                * abytes * 2 * ring(pt.tp) if pt.tp > 1 else 0.0
            coll += 2.0 * (c.n_params() * pbytes / pt.tp) * ring(pt.dp * n_pods)
            cap = c.n_params() * pbytes / chips + kvb / chips \
                + tokens / max(pt.dp * n_pods, 1) * c.d_model * abytes * 4 / pt.tp
            model_flops = 2.0 * c.n_active_params() * tokens

    coll_per_chip = coll  # all branches above account bytes per chip already
    compute_s = flops / (chips * hw.peak_flops)
    memory_s = traffic / (chips * hw.hbm_bw)
    collective_s = coll_per_chip / hw.ici_bw
    latency = max(compute_s, memory_s, collective_s)
    return CostReport(
        flops=flops, hbm_traffic=traffic, coll_bytes_per_chip=coll_per_chip,
        hbm_capacity_per_chip=cap, compute_s=compute_s, memory_s=memory_s,
        collective_s=collective_s, latency_s=latency, model_flops=model_flops,
        fits=cap <= hw.hbm_bytes, detail=detail, hw=hw)


def estimate_mode(cfg: ModelConfig, cell: ShapeCell, pt: DesignPoint, *,
                  depth: int, width: float, hw: HardwareSpec = DEFAULT_HW,
                  n_pods: int = 1) -> CostReport:
    """Analytical estimate for a NeuroMorph ``(depth, width)`` serving mode.

    Width-morphs the config at full depth, then truncates the layer stack to
    ``depth`` groups — the same geometry ``MorphController`` compiles — so
    reports are comparable across modes. ``pt`` should carry ``width=1.0``
    (the morph happens here, not in ``estimate``). Shared by ``SLOPolicy``'s
    online correction and the runtime autoscaler's blended evaluator.
    """
    from repro_torch.core import elastic as _el  # late import (cycle)

    cfg_m = _el.morph_config(cfg, dataclasses.replace(
        _mode_stub, depth=cfg.n_groups, width=width))
    cfg_m = cfg_m.scaled(n_layers=depth * cfg.period)
    return estimate(cfg_m, cell, pt, hw=hw, n_pods=n_pods)


# tiny helper for morph_config call above
from repro_torch.configs.base import MorphMode as _MM  # noqa: E402

_mode_stub = _MM(depth=1, width=1.0)
