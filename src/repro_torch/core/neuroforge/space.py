"""NeuroForge design point.

``DesignPoint`` is the configuration the analytical model estimates
(distribution degrees + step options). This slice uses it only for the SLO
policy's single-card estimate; the searchable ``DesignSpace`` arrives with
the MOGA slice of the port.
"""
from __future__ import annotations

from dataclasses import dataclass


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

