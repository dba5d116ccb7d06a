"""Re-export shim (counterpart of ``repro.core.aggregate``): gradient
aggregation lives in :mod:`repro_torch.comm.collectives`."""
from __future__ import annotations

from repro_torch.comm.collectives import (
    COLLECTIVES,
    dense_mean,
    scatter_add_payloads,
)

AGGREGATIONS = tuple(sorted(COLLECTIVES))

__all__ = ["AGGREGATIONS", "dense_mean", "scatter_add_payloads"]
