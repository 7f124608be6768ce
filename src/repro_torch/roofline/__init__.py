"""Roofline terms of the dry run's plans with the H100's constants (the
port of the JAX package's ``roofline``)."""
from .analysis import (
    HBM_BW,
    IB_BW,
    NVLINK_BW,
    NVLINK_DOMAIN,
    PEAK_FLOPS,
    Collective,
    collective_bytes,
    hbm_traffic_model,
    model_flops,
    roofline_report,
    roofline_terms,
)

__all__ = [
    "PEAK_FLOPS", "HBM_BW", "NVLINK_BW", "IB_BW", "NVLINK_DOMAIN",
    "Collective", "collective_bytes", "hbm_traffic_model", "model_flops",
    "roofline_terms", "roofline_report",
]
