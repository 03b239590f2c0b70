"""NeuroForge analytical models (the parts the serving SLO policy needs)."""
from repro_torch.core.neuroforge.analytical import CostReport, estimate, estimate_mode, kv_cache_bytes
from repro_torch.core.neuroforge.hw import DEFAULT_HW, H100, V5E, HardwareSpec, dtype_bytes
from repro_torch.core.neuroforge.space import DesignPoint

__all__ = [
    "CostReport",
    "estimate",
    "estimate_mode",
    "kv_cache_bytes",
    "DEFAULT_HW",
    "H100",
    "V5E",
    "HardwareSpec",
    "dtype_bytes",
    "DesignPoint",
]
