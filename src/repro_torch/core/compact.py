"""Compact sparsifier state for the trainer (counterpart of
``repro.core.compact``), batched over W workers on one card.

Algorithm 2 reads ``a^{t-1}``, ``s^{t-1}`` and ``g^{t-1}`` only at the k
coordinates a worker sent, so the exact per-worker state is the dense
error ``eps [L]`` plus three k-vectors. Every tensor here carries a
leading worker axis: ``eps [W, L]``, ``sent_* [W, k]``, ``t [W]``. Index
tensors are int64 (torch's indexing type); the wire codec carries them
as int32.

Under coordinate weighting, ``compact_finalize(den=...)`` records the
sender mass the server divided by at the sent coordinates
(``CompactState.sent_w``), and the next round's posterior weighs this
worker with ``omega / sent_w`` there. ``compact_select(k_dyn=...)``
takes the adaptive-k controller's per-round k: selection runs at the
static capacity and the payload keeps its first ``k_dyn`` slots
(:func:`_apply_k_dyn`).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core import selectors as sel_lib
from repro_torch.core.selectors import topk_stable
from repro_torch.core.sparsify import DenseState, SparsifierConfig, make_sparsifier
from repro_torch.kernels.regtopk_score import ieee_div, pow_y


class CompactState(NamedTuple):
    eps: torch.Tensor  # [W, L] dense sparsification error
    sent_vals: torch.Tensor  # [W, k] a^{t-1} at the sent coords
    sent_g: torch.Tensor  # [W, k] g^{t-1} (aggregated) at the sent coords
    sent_idx: torch.Tensor  # [W, k] int64 coords sent at t-1
    # [W, k] the sender mass den[j] the server divided by at the sent
    # coords (coordinate weighting); exactly 1.0 under worker weighting, so
    # omega / sent_w == omega bit for bit there
    sent_w: torch.Tensor
    t: torch.Tensor  # [W] int32 round counter


def compact_init(workers: int, length: int, k: int, device="cuda",
                 dtype: torch.dtype = torch.float32) -> CompactState:
    """The all-zero state of ``workers`` rows, the error and ``sent_*``
    slots in ``dtype`` (the trainer's ``state_dtype``)."""
    z = torch.zeros((workers, k), dtype=dtype, device=device)
    return CompactState(
        eps=torch.zeros((workers, length), dtype=dtype, device=device),
        sent_vals=z,
        sent_g=z.clone(),
        sent_idx=torch.zeros((workers, k), dtype=torch.int64, device=device),
        sent_w=z.clone(),
        t=torch.zeros((workers,), dtype=torch.int32, device=device),
    )


def select_rows(st: CompactState, rows: torch.Tensor) -> CompactState:
    """The state of the workers ``rows`` only."""
    return CompactState(*(x[rows] for x in st))


def _apply_k_dyn(vals: torch.Tensor, k_dyn: torch.Tensor) -> torch.Tensor:
    """Keep the first ``k_dyn`` slots of a payload listed by descending
    score, the dynamic top-``k_dyn``; the other slots keep their distinct
    indices and carry +0.0, a no-op on the wire. The value is selected,
    not multiplied by the keep mask: the JAX package's product gives +0.0
    under ``jax.jit`` (how its simulator and trainer run it), where a
    product in torch keeps the sign of a negative value."""
    slot = torch.arange(vals.shape[-1], device=vals.device)
    return torch.where(slot < k_dyn, vals, 0.0)


def compact_select(
    cfg: SparsifierConfig,
    st: CompactState,
    g: torch.Tensor,
    k: int,
    *,
    k_dyn: Optional[torch.Tensor] = None,
    fastpath: Optional[str] = None,
    counts=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Select coordinates for every worker. ``g`` is ``[W, L]``.
    Returns ``(a [W, L], vals [W, k], idx [W, k])``.

    Kinds: ``topk`` and ``regtopk``, scored and then selected by
    ``cfg.selector`` (``exact``: the stable top-k; ``threshold``: the
    bisection mask of ``selectors.threshold_topk_mask``, ranked into k
    slots by ``mask_to_payload``), and ``cyclic``, the coordinated
    round-robin window ``[t * k, t * k + k) mod L``.

    ``fastpath="on"`` routes fusable configs through the fused
    select→encode kernel (``repro_torch.comm.fastpath``); its certificate
    falls back to this dense path per worker, so the payload is the same
    either way. ``"auto"`` fuses where the device can run the kernel and
    the default ``fastpath.ThroughputTable`` prices the fused path faster
    (the trainer decides per leaf instead, with ``fastpath.leaf_fused``).
    ``None``/``"off"`` is dense selection.
    ``counts`` (a ``fastpath.FastpathCounts``) tallies fused rounds and
    fallbacks.

    ``k_dyn`` (a tensor, ``<= k``) is the adaptive controller's per-round
    k: selection still runs at the capacity ``k``, fused or not, and then
    keeps the payload's first ``k_dyn`` slots (:func:`_apply_k_dyn`).
    Only ``topk`` and ``regtopk`` under the exact selector take it; at
    ``k_dyn == k`` the payload is the static path's bit for bit."""
    L = g.shape[1]
    if k_dyn is not None and (
        cfg.kind not in ("topk", "regtopk") or cfg.selector != "exact"
    ):
        raise ValueError(
            "dynamic per-round k needs a magnitude-scored fixed-k kind "
            "('topk'/'regtopk') under selector='exact'; got kind="
            f"{cfg.kind!r} selector={cfg.selector!r}"
        )
    if fastpath not in (None, "off"):
        from repro_torch.comm import fastpath as fp

        if fastpath not in fp.FASTPATH_MODES:
            raise ValueError(
                f"unknown fastpath {fastpath!r}; "
                f"available: {fp.FASTPATH_MODES}"
            )
        if (
            st.eps.dtype == torch.float32
            and fp.config_fusable(cfg)[0]
            and fp.shape_fusable(L, k)[0]
            and (
                fastpath == "on"
                or (
                    fp.backend_supports(g.device)
                    and fp.ThroughputTable().prefers_fused(L, k)
                )
            )
        ):
            a, vals, idx = fp.fused_compact_select(cfg, st, g, k, counts=counts)
            return a, vals if k_dyn is None else _apply_k_dyn(vals, k_dyn), idx
    a = st.eps + g.to(st.eps.dtype)
    if cfg.kind == "none":
        raise ValueError("'none' bypasses compact_select")
    if cfg.kind == "cyclic":
        # coordinated round-robin, the same coordinates on every worker: a
        # function of (t, k, L) alone. t * k is int32 and wraps where the
        # JAX package's does; % is the floor modulo in both.
        start = (st.t * k) % L
        arange = torch.arange(k, dtype=st.t.dtype, device=a.device)
        idx = ((start[:, None] + arange) % L).long()
        return a, torch.gather(a, 1, idx), idx
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
    if cfg.selector == "exact":
        _, idx = topk_stable(score, k)
        # zero scores are never selected: such slots keep their distinct
        # top-k index and carry value +0.0 (selected, not multiplied by
        # the mask, which would keep the sign of a negative a), a no-op
        # on the wire.
        live = torch.gather(score, 1, idx) > 0
        vals = torch.where(live, torch.gather(a, 1, idx), 0.0)
        return a, vals if k_dyn is None else _apply_k_dyn(vals, k_dyn), idx
    if cfg.selector == "threshold":
        mask = sel_lib.threshold_topk_mask(score, k)
        vals, idx = sel_lib.mask_to_payload(mask, a, k)
        return a, vals, idx
    raise ValueError(
        f"compact_select does not support selector {cfg.selector!r}; "
        "available: 'exact', 'threshold'"
    )


def _at(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x`` at each row's coords ``idx [R, k]``: ``x[idx]`` for one common
    ``x [L]``; for ``x [S, L]``, one per model shard, row ``r`` (worker
    major, shard fastest) reads ``x[r % S]``."""
    if x.dim() == 1:
        return x[idx]
    shard = torch.arange(idx.shape[0], device=idx.device) % x.shape[0]
    return x[shard[:, None], idx]


def _sent_w_at(
    idx: torch.Tensor, den: Optional[torch.Tensor], like: torch.Tensor
) -> torch.Tensor:
    """The sender mass at the sent coords: ``den[idx]`` under coordinate
    weighting, exactly 1.0 under worker weighting (``den=None``)."""
    if den is None:
        return torch.ones_like(like)
    return _at(den, idx).to(like.dtype)


def compact_finalize(
    st: CompactState,
    a: torch.Tensor,
    vals: torch.Tensor,
    idx: torch.Tensor,
    agg: torch.Tensor,
    den: Optional[torch.Tensor] = None,
) -> CompactState:
    """Post-aggregation update: ``eps' = a - scatter_add(vals, idx)``,
    zero at every sent coordinate (``vals == a[idx]`` there) and the whole
    of ``a`` at a padding slot's index, so no unsent mass leaves the error
    feedback. ``agg [L]`` is the common aggregate, recorded at the sent
    coordinates for the next round's posterior; ``den [L]`` is the sender
    mass under coordinate weighting. It is :func:`compact_finalize_sent`
    with the payload as sent, which is what a lossless wire delivers."""
    sent_dense = torch.zeros_like(a).scatter_add_(1, idx, vals)
    return compact_finalize_sent(st, a, vals, idx, sent_dense, agg, den)


def compact_finalize_sent(
    st: CompactState,
    a: torch.Tensor,
    sent_vals: torch.Tensor,
    sent_idx: torch.Tensor,
    sent_dense: torch.Tensor,
    agg: torch.Tensor,
    den: Optional[torch.Tensor] = None,
) -> CompactState:
    """Error feedback against what was actually transmitted: ``eps' = a -
    sent_dense`` with ``sent_dense [W, L]`` the decoded contribution (so a
    lossy codec's residual stays in the error), and the decoded payload
    recorded for next round's posterior. ``agg [L]`` is the common
    aggregate; ``den [L]`` the sender mass under coordinate weighting
    (``None``: worker weighting, a mass of exactly 1). Rows of several
    model shards take ``agg`` and ``den`` as ``[S, L]``, one per shard
    (:func:`_at`)."""
    return CompactState(
        eps=a - sent_dense.to(a.dtype),
        sent_vals=sent_vals.to(st.sent_vals.dtype),
        sent_g=_at(agg, sent_idx).to(st.sent_g.dtype),
        sent_idx=sent_idx,
        sent_w=_sent_w_at(sent_idx, den, st.sent_w),
        t=st.t + 1,
    )


def reference_step(
    cfg: SparsifierConfig,
    st: CompactState,
    g: torch.Tensor,
    g_prev_dense: torch.Tensor,
    k: int,
    omega_prev: Optional[torch.Tensor] = None,
):
    """The dense-state step on the state the compact one rebuilds, for
    equivalence tests: ``(ghat [W, L], mask [W, L], DenseState)`` from the
    exact-selector sparsifier of ``cfg.kind`` with ``g_prev_dense [L]`` the
    previous aggregate."""
    W, L = g.shape
    sent = torch.where(st.t > 0, 1.0, 0.0).to(g.dtype)[:, None].expand(W, k)
    z = torch.zeros((W, L), dtype=g.dtype, device=g.device)
    dense = DenseState(
        eps=st.eps,
        a_prev=z.scatter(1, st.sent_idx, st.sent_vals),
        s_prev=z.scatter(1, st.sent_idx, sent),
        t=st.t,
    )
    sp = make_sparsifier(
        dataclasses.replace(cfg, sparsity=k / L, selector="exact")
    )
    return sp.step(dense, g, g_prev_dense, omega_prev=omega_prev)
