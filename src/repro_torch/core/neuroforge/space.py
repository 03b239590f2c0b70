"""NeuroForge design-space definition.

Port of ``repro.core.neuroforge.space``. The FPGA genome (per-layer PE
counts, pipeline depth — paper Eq. 14/15 and Algorithm 1's ``P`` vector)
becomes the distribution/schedule genome of an SPMD program on a fixed
pod. Each field is a discrete axis; an individual is a vector of choice
indices. ``DesignPoint`` is the decoded configuration that the launcher can
actually apply (sharding rules + step options), which is what makes the
DSE *actionable* rather than advisory. The SLO policy estimates one card's
``DesignPoint``; ``DesignSpace`` is what ``moga.run_moga`` searches.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.configs.base import ModelConfig, ShapeCell


@dataclass(frozen=True)
class DesignPoint:
    dp: int  # data-parallel degree (per pod)
    tp: int  # tensor/model-parallel degree
    microbatches: int  # gradient-accumulation steps (train only)
    remat: str  # none | dots | full
    param_dtype: str  # bfloat16 | float32
    moment_dtype: str  # bfloat16 | float32
    grad_comm: str  # allreduce | reduce_scatter | int8
    kv_quant: bool
    attn_chunk: int
    capacity_factor: float
    width: float  # NeuroMorph width fraction (serve cells; 1.0 = full)

    def name(self) -> str:
        return (f"dp{self.dp}tp{self.tp}mb{self.microbatches}_{self.remat}"
                f"_{self.param_dtype[:2]}_{self.moment_dtype[:2]}_{self.grad_comm}"
                f"{'_kvq' if self.kv_quant else ''}_w{int(self.width * 100)}")


def _factor_pairs(n: int) -> List[Tuple[int, int]]:
    out = []
    d = 1
    while d * d <= n:
        if n % d == 0:
            out.append((d, n // d))
            if d != n // d:
                out.append((n // d, d))
        d += 1
    return sorted(out)


def valid_tp(cfg: ModelConfig, tp: int) -> bool:
    """TP degree must divide the sharded inner dims."""
    if cfg.d_ff and cfg.d_ff % tp:
        return False
    if cfg.n_experts:
        if cfg.n_experts % tp and cfg.moe_d_ff % tp:
            return False  # neither EP nor expert-TP divides
    if cfg.n_heads and cfg.q_dim % tp:
        return False
    if cfg.ssm_state and cfg.ssm_d_inner % tp:
        return False
    if cfg.padded_vocab() % tp:
        return False
    return True


@dataclass
class DesignSpace:
    cfg: ModelConfig
    cell: ShapeCell
    n_chips: int = 256

    def fields(self) -> Dict[str, Tuple]:
        # batch must split over dp (or be replicated for decode 2d policy)
        pairs = [(dp, tp) for dp, tp in _factor_pairs(self.n_chips)
                 if valid_tp(self.cfg, tp) and
                 (self.cell.kind == "decode" or self.cell.global_batch % dp == 0)]
        if not pairs:
            raise ValueError(
                f"no valid (dp, tp) factorization of {self.n_chips} chips: every "
                f"tp fails valid_tp for {self.cfg.name!r} or dp does not divide "
                f"global_batch={self.cell.global_batch} ({self.cell.kind} cell)")
        train = self.cell.kind == "train"
        # Microbatch axis spans the most permissive (smallest-dp) shard; decode()
        # clamps each individual against its own dp so large-dp points stay valid.
        per_shard = max(1, self.cell.global_batch // max(1, pairs[0][0]))
        mbs = tuple(m for m in (1, 2, 4, 8, 16, 32) if m <= max(per_shard, 1)) or (1,)
        f: Dict[str, Tuple] = {
            "dp_tp": tuple(pairs),
            "microbatches": mbs if train else (1,),
            "remat": ("none", "dots", "full") if train else ("none",),
            "param_dtype": ("bfloat16", "float32") if train else ("bfloat16",),
            "moment_dtype": ("float32", "bfloat16") if train else ("float32",),
            "grad_comm": ("allreduce", "reduce_scatter", "int8") if train else ("allreduce",),
            "kv_quant": (False, True) if self.cell.kind == "decode" else (False,),
            "attn_chunk": (512, 1024, 2048),
            "capacity_factor": (1.0, 1.25, 1.5) if self.cfg.n_experts else (1.25,),
            "width": tuple(sorted(self.cfg.elastic.width_fractions, reverse=True))
                     if self.cell.kind != "train" else (1.0,),
        }
        return f

    def decode(self, idx: Sequence[int]) -> DesignPoint:
        f = self.fields()
        vals = {k: choices[i % len(choices)] for (k, choices), i in zip(f.items(), idx)}
        dp, tp = vals.pop("dp_tp")
        if self.cell.kind == "train":
            # The shared microbatch axis is sized for the smallest dp; clamp to
            # this individual's own per-shard batch so the point stays launchable.
            per_shard = max(1, self.cell.global_batch // max(1, dp))
            if vals["microbatches"] > per_shard:
                fit = [m for m in f["microbatches"] if m <= per_shard]
                vals["microbatches"] = max(fit) if fit else 1
        return DesignPoint(dp=dp, tp=tp, **vals)

    def bounds(self) -> List[int]:
        return [len(c) for c in self.fields().values()]

    def size(self) -> int:
        n = 1
        for b in self.bounds():
            n *= b
        return n

    def enumerate_all(self, limit: Optional[int] = None):
        ranges = [range(b) for b in self.bounds()]
        for i, idx in enumerate(itertools.product(*ranges)):
            if limit is not None and i >= limit:
                return
            yield self.decode(idx)
