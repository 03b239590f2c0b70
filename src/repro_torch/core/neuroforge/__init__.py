"""NeuroForge: analytical models, the design space and the MOGA that
searches it (the offline search, and the online autoscaler's)."""
from repro_torch.core.neuroforge.analytical import (
    CostReport,
    estimate,
    estimate_mode,
    forward_costs,
    kv_cache_bytes,
)
from repro_torch.core.neuroforge.hw import (DEFAULT_HW, H100, V5E, HardwareSpec,
                                           dtype_bytes)
from repro_torch.core.neuroforge.moga import (
    Constraints,
    Individual,
    MogaResult,
    non_dominated,
    pareto_is_consistent,
    run_moga,
)
from repro_torch.core.neuroforge.space import DesignPoint, DesignSpace, valid_tp

__all__ = [
    "CostReport",
    "estimate",
    "estimate_mode",
    "forward_costs",
    "kv_cache_bytes",
    "DEFAULT_HW",
    "H100",
    "V5E",
    "HardwareSpec",
    "dtype_bytes",
    "Constraints",
    "Individual",
    "MogaResult",
    "non_dominated",
    "pareto_is_consistent",
    "run_moga",
    "DesignPoint",
    "DesignSpace",
    "valid_tp",
]
