"""Sparsifier configuration (counterpart of
``repro.core.sparsify.SparsifierConfig``).

Slice 1 ports the config only: the trainer's state is the compact
``repro_torch.core.compact.CompactState``, not the simulator's dense
per-kind state.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class SparsifierConfig:
    """kind      — "none" | "topk" | "regtopk"
    sparsity  — S = k/J (paper's sparsification factor)
    mu        — RegTop-k innovation-CDF scale (paper's mu)
    y         — prior exponent |a|^y (paper Remark 4)
    q_const   — the "very large constant Q" for unsent coordinates
    omega     — this worker's aggregation weight omega_n
    selector  — "exact" (the only selector ported so far)
    """

    kind: str = "regtopk"
    sparsity: float = 0.01
    mu: float = 1.0
    y: float = 1.0
    q_const: float = 1e9
    omega: float = 1.0
    selector: str = "exact"
