"""Compact sparsifier state for the trainer (counterpart of
``repro.core.compact``), batched over W workers on one card.

Algorithm 2 reads ``a^{t-1}``, ``s^{t-1}`` and ``g^{t-1}`` only at the k
coordinates a worker sent, so the exact per-worker state is the dense
error ``eps [L]`` plus three k-vectors. Every tensor here carries a
leading worker axis: ``eps [W, L]``, ``sent_* [W, k]``, ``t [W]``. Index
tensors are int64 (torch's indexing type); the wire codec carries them
as int32.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core.selectors import topk_stable
from repro_torch.core.sparsify import SparsifierConfig
from repro_torch.kernels.regtopk_score import ieee_div, pow_y


class CompactState(NamedTuple):
    eps: torch.Tensor  # [W, L] dense sparsification error
    sent_vals: torch.Tensor  # [W, k] a^{t-1} at the sent coords
    sent_g: torch.Tensor  # [W, k] g^{t-1} (aggregated) at the sent coords
    sent_idx: torch.Tensor  # [W, k] int64 coords sent at t-1
    sent_w: torch.Tensor  # [W, k] sender mass at the sent coords (1.0 here)
    t: torch.Tensor  # [W] int32 round counter


def compact_init(workers: int, length: int, k: int, device="cuda") -> CompactState:
    z = torch.zeros((workers, k), device=device)
    return CompactState(
        eps=torch.zeros((workers, length), device=device),
        sent_vals=z,
        sent_g=z.clone(),
        sent_idx=torch.zeros((workers, k), dtype=torch.int64, device=device),
        sent_w=z.clone(),
        t=torch.zeros((workers,), dtype=torch.int32, device=device),
    )


def select_rows(st: CompactState, rows: torch.Tensor) -> CompactState:
    """The state of the workers ``rows`` only."""
    return CompactState(*(x[rows] for x in st))


def compact_select(
    cfg: SparsifierConfig,
    st: CompactState,
    g: torch.Tensor,
    k: int,
    *,
    fastpath: Optional[str] = None,
    counts=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Select coordinates for every worker. ``g`` is ``[W, L]``.
    Returns ``(a [W, L], vals [W, k], idx [W, k])``.

    ``fastpath="on"`` routes fusable configs through the fused
    select→encode kernel (``repro_torch.comm.fastpath``); its certificate
    falls back to this dense path per worker, so the payload is the same
    either way. ``None``/``"off"`` is dense selection. ``counts`` (a
    ``fastpath.FastpathCounts``) tallies fused rounds and fallbacks."""
    L = g.shape[1]
    if fastpath not in (None, "off"):
        from repro_torch.comm import fastpath as fp

        if fastpath != "on":
            raise ValueError(
                f"fastpath {fastpath!r} is not ported; the port has "
                "'on' and 'off'"
            )
        if (
            st.eps.dtype == torch.float32
            and fp.config_fusable(cfg)[0]
            and fp.shape_fusable(L, k)[0]
        ):
            return fp.fused_compact_select(cfg, st, g, k, counts=counts)
    a = st.eps + g.to(st.eps.dtype)
    if cfg.selector != "exact":
        raise ValueError(
            f"selector {cfg.selector!r} is not ported; the port has 'exact'"
        )
    amag = torch.abs(a)
    if cfg.kind == "topk":
        score = amag
    elif cfg.kind == "regtopk":
        # the exponent applies before the sent-coordinate regularization;
        # unsent coords carry the likelihood C = tanh(Q/mu) -> 1, and
        # t == 0 is plain Top-k (Alg. 2 line 2).
        mag = pow_y(amag, cfg.y)
        w_safe = torch.where(st.sent_w > 0, st.sent_w, 1.0)
        omega_vec = torch.full_like(w_safe, cfg.omega) / w_safe
        denom = omega_vec * torch.gather(a, 1, st.sent_idx)
        safe = torch.where(denom == 0, 1.0, denom)
        delta = (st.sent_g - omega_vec * st.sent_vals) / safe
        reg = torch.tanh(ieee_div(torch.abs(1.0 + delta), cfg.mu))
        sent_score = torch.gather(mag, 1, st.sent_idx) * reg
        scored = mag.scatter(1, st.sent_idx, sent_score)
        score = torch.where((st.t == 0)[:, None], amag, scored)
    else:
        raise ValueError(f"unsupported compact kind {cfg.kind!r}")
    _, idx = topk_stable(score, k)
    # zero scores are never selected: such slots keep their distinct
    # top-k index and carry value 0, a no-op on the wire.
    vals = torch.gather(a, 1, idx) * (torch.gather(score, 1, idx) > 0)
    return a, vals, idx


def compact_finalize_sent(
    st: CompactState,
    a: torch.Tensor,
    sent_vals: torch.Tensor,
    sent_idx: torch.Tensor,
    sent_dense: torch.Tensor,
    agg: torch.Tensor,
) -> CompactState:
    """Error feedback against what was actually transmitted: ``eps' = a -
    sent_dense`` with ``sent_dense [W, L]`` the decoded contribution, and
    the decoded payload recorded for next round's posterior. ``agg [L]``
    is the common aggregate; under worker weighting the sender mass at
    every sent coord is exactly 1."""
    return CompactState(
        eps=a - sent_dense.to(a.dtype),
        sent_vals=sent_vals.to(st.sent_vals.dtype),
        sent_g=agg[sent_idx].to(st.sent_g.dtype),
        sent_idx=sent_idx,
        sent_w=torch.ones_like(st.sent_w),
        t=st.t + 1,
    )
