"""Estimator validation: analytical model vs compiled ground truth.

The paper validates NeuroForge's analytical estimators against post-synthesis
reports (Fig. 10 / Table III: >95% DSP/BRAM accuracy, 10-15% latency error).
Here ground truth is the dry-run's ``cost_analysis()`` / collective walk, and
the claim to reproduce is: FLOPs estimate within ~10%, traffic and collective
estimates within ~2x (XLA fusion makes byte counts implementation-defined —
same caveat the paper notes for LUTs).

Port of ``repro.core.neuroforge.validate``: pure Python over a record
dict. The dry-run that writes such records (``repro.launch.dryrun``) reads
XLA's ``cost_analysis()`` and stays in the JAX package, so on the port
these functions compare the analytical model to records made there.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

from repro_torch.configs.base import ModelConfig, ShapeCell
from repro_torch.core.neuroforge.analytical import estimate
from repro_torch.core.neuroforge.space import DesignPoint


@dataclass
class ValidationRow:
    arch: str
    shape: str
    point_name: str
    flops_est: float
    flops_hlo: float
    bytes_est: float
    bytes_hlo: float
    coll_est: float
    coll_hlo: float

    @property
    def flops_err(self) -> float:
        return abs(self.flops_est - self.flops_hlo) / max(self.flops_hlo, 1e-9)

    @property
    def bytes_ratio(self) -> float:
        return self.bytes_est / max(self.bytes_hlo, 1e-9)

    @property
    def coll_ratio(self) -> float:
        return self.coll_est / max(self.coll_hlo, 1e-9)

    def as_dict(self) -> Dict:
        return {
            "arch": self.arch, "shape": self.shape, "point": self.point_name,
            "flops_err_pct": round(self.flops_err * 100, 1),
            "bytes_ratio": round(self.bytes_ratio, 2),
            "coll_ratio": round(self.coll_ratio, 2),
            "flops_est": self.flops_est, "flops_hlo": self.flops_hlo,
            "bytes_est": self.bytes_est, "bytes_hlo": self.bytes_hlo,
            "coll_est": self.coll_est, "coll_hlo": self.coll_hlo,
        }


def validate_against_record(cfg: ModelConfig, cell: ShapeCell, pt: DesignPoint,
                            record: Dict, n_pods: int = 1) -> ValidationRow:
    """Compare an analytical estimate to one dry-run JSON record."""
    rep = estimate(cfg, cell, pt, n_pods=n_pods)
    chips = pt.dp * pt.tp * n_pods
    return ValidationRow(
        arch=cfg.name, shape=cell.name, point_name=pt.name(),
        flops_est=rep.flops,
        flops_hlo=record["cost"]["flops_per_device"] * chips,
        bytes_est=rep.hbm_traffic,
        bytes_hlo=record["cost"]["bytes_per_device"] * chips,
        coll_est=rep.coll_bytes_per_chip,
        coll_hlo=record["collectives"]["wire_bytes_per_chip"],
    )


def point_from_record(record: Dict, mesh_dp: int = 16, mesh_tp: int = 16) -> DesignPoint:
    k = record["resolved_knobs"]
    return DesignPoint(
        dp=mesh_dp, tp=mesh_tp, microbatches=k["microbatches"], remat=k["remat"],
        param_dtype=k["param_dtype"], moment_dtype=k["moment_dtype"] or "float32",
        grad_comm="allreduce", kv_quant=k["kv_quant"], attn_chunk=k["attn_chunk"],
        capacity_factor=k["capacity_factor"], width=k["width"])
