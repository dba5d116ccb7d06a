"""Sparsifiers, selectors, the simulator, the compact runtime and the
trainer's sparsify-aggregate round (``repro.core``'s counterparts).

The library boundary, as ``repro.core`` offers it to ``examples/``::

    from repro_torch.core import DistributedSim, SparsifierConfig
"""
from repro_torch.core.aggregate import (
    AGGREGATIONS,
    dense_mean,
    scatter_add_payloads,
)
from repro_torch.core.selectors import (
    SELECTORS,
    exact_topk_mask,
    fixed_k_payload,
    get_selector,
    mask_to_payload,
    sparsity_to_k,
    threshold_topk_mask,
)
from repro_torch.core.simulator import DistributedSim, SimState
from repro_torch.core.sparsify import (
    KINDS,
    DenseState,
    HardThreshold,
    NoneSparsifier,
    RegTopK,
    Sparsifier,
    SparsifierConfig,
    TopK,
    make_sparsifier,
)

__all__ = [
    "AGGREGATIONS",
    "DenseState",
    "DistributedSim",
    "HardThreshold",
    "KINDS",
    "NoneSparsifier",
    "RegTopK",
    "SELECTORS",
    "SimState",
    "Sparsifier",
    "SparsifierConfig",
    "TopK",
    "dense_mean",
    "exact_topk_mask",
    "fixed_k_payload",
    "get_selector",
    "make_sparsifier",
    "mask_to_payload",
    "scatter_add_payloads",
    "sparsity_to_k",
    "threshold_topk_mask",
]
