"""Target-hardware constants used by every analytical model.

The port's default target is one NVIDIA H100 SXM. Its numbers are NVIDIA's
data-sheet peaks (dense bf16 tensor-core rate without sparsity, HBM3
bandwidth and capacity, board power), not measurements. ``V5E`` keeps the
TPU v5e constants of the JAX package so estimates can still be compared
with it. The FPGA paper's resource vector (DSP / LUT / BRAM slices) maps
onto (peak FLOP/s, HBM bytes, interconnect bandwidth).
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class HardwareSpec:
    name: str = "tpu-v5e"
    peak_flops: float = 197e12  # bf16 FLOP/s per chip
    hbm_bw: float = 819e9  # bytes/s per chip
    hbm_bytes: float = 16e9  # capacity per chip
    ici_bw: float = 50e9  # bytes/s per link (one active link per phase, worst case)
    tdp_watts: float = 200.0  # per chip, for Table-VI-style J/inference estimates


V5E = HardwareSpec()

# NVIDIA H100 SXM data sheet: 989 TFLOP/s dense bf16, 3.35 TB/s HBM3, 80 GB,
# NVLink 450 GB/s each way per card, 700 W board power.
H100 = HardwareSpec(name="h100-sxm", peak_flops=989e12, hbm_bw=3.35e12,
                    hbm_bytes=80e9, ici_bw=450e9, tdp_watts=700.0)

DEFAULT_HW = H100


def dtype_bytes(name: str) -> int:
    return {"float32": 4, "bfloat16": 2, "float16": 2, "int8": 1}[name]
