"""The paper's own accelerator configurations (GUST length-8/-87/-256,
1D-256, Serpens) — re-exported from the hardware model for benchmarks.

Counterpart of ``repro.configs.gust_paper``."""

from ..core.hardware_model import (
    GUST_8,
    GUST_87,
    GUST_256,
    SERPENS,
    SYSTOLIC_1D_256,
)

__all__ = ["GUST_8", "GUST_87", "GUST_256", "SERPENS", "SYSTOLIC_1D_256"]
