"""Fused select→encode fastpath: fusability, candidate budget and runtime
routing (counterpart of ``repro.comm.fastpath``).

The trainer has the modes ``"on"`` (fuse every fusable leaf) and
``"off"``. The JAX package's ``"auto"`` prices the two paths with a
throughput table whose default is a TPU memory rate; the trainer refuses
it until a later slice refits that table on the card (ROADMAP queue 1
item 5). The simulator fuses only its scoring stage
(:func:`make_score_fn`) and takes ``"auto"`` too, resolved by
:func:`backend_supports`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from repro_torch.comm.codec import get_codec

FASTPATH_MODES = ("off", "on")

# tanh(x) == 1.0 exactly in float32 for x >= ~8.7; with margin. Below this,
# the unsent-coordinate regularizer C = tanh((1 + Q)/mu) is < 1 and the
# fused score (which applies C explicitly) diverges from the dense path
# (which leaves unsent scores untouched).
SATURATION_MIN = 12.0

# per-tile candidate budget bounds: the kernel runs m selection rounds, so
# m is capped; the floor keeps the certificate hit rate high on tiny k.
MIN_M = 8
MAX_M = 128

_TILE = 8192  # kernels layout contract: (8, 1024) f32 tiles


@dataclasses.dataclass
class FastpathCounts:
    """Tally of fused worker-rounds and of those whose certificate failed
    and fell back to dense selection. ``hit_rate`` is the share of
    worker-rounds that used the kernel's answer."""

    rounds: int = 0
    fallbacks: int = 0

    @property
    def hit_rate(self) -> float:
        return (self.rounds - self.fallbacks) / max(1, self.rounds)


def _n_tiles(length: int) -> int:
    return max(1, -(-int(length) // _TILE))


def candidate_budget(length: int, k: int) -> int:
    """Per-tile candidate count ``m``: ~2.5x the expected per-tile winner
    count plus slack, clamped to [MIN_M, MAX_M].

    >>> candidate_budget(8192, 8)
    28
    >>> candidate_budget(10**6, 10)
    9
    """
    per_tile = k / _n_tiles(length)
    return max(MIN_M, min(MAX_M, math.ceil(2.5 * per_tile) + 8))


def config_fusable(scfg) -> Tuple[bool, str]:
    """The kernel computes the topk/regtopk score under the exact selector,
    for y > 0 and a saturated unsent regularizer (see
    ``repro.comm.fastpath.config_fusable`` for why each rule holds)."""
    if scfg.kind not in ("topk", "regtopk"):
        return False, f"kind {scfg.kind!r} is not fusable"
    if scfg.selector != "exact":
        return False, f"selector {scfg.selector!r} is not fusable"
    if not scfg.y > 0:
        return False, f"y={scfg.y} breaks the score chain"
    if (1.0 + scfg.q_const) / scfg.mu < SATURATION_MIN:
        return False, (
            f"tanh((1+{scfg.q_const:g})/{scfg.mu:g}) does not saturate "
            "to 1.0 — scores would diverge from the dense path"
        )
    return True, "ok"


def wire_fusable(codec: str, collective: str) -> Tuple[bool, str]:
    """The codec must have a fused epilogue and the collective must move
    payloads.

    >>> wire_fusable("coo_fp32", "sparse_allgather")[0]
    True
    """
    if not get_codec(codec).supports_fused:
        return False, f"codec {codec!r} has no encode_fused epilogue"
    if collective == "dense_allreduce":
        return False, "dense_allreduce moves the dense vector, not payloads"
    return True, "ok"


def shape_fusable(length: int, k: int) -> Tuple[bool, str]:
    """``k`` must fit in ``n_tiles * m`` candidates.

    >>> shape_fusable(65536, 64)[0]
    True
    >>> shape_fusable(8192, 1024)[0]
    False
    """
    m = candidate_budget(length, k)
    if k > _n_tiles(length) * m:
        return False, (
            f"k={k} exceeds the {_n_tiles(length)}x{m} candidate budget"
        )
    return True, "ok"


def fusable(scfg, codec: str, collective: str, length: int, k: int):
    """Full fusability matrix: config x wire x shape."""
    for ok, why in (
        config_fusable(scfg),
        wire_fusable(codec, collective),
        shape_fusable(length, k),
    ):
        if not ok:
            return False, why
    return True, "ok"


def backend_supports(device) -> bool:
    """Whether ``fastpath="auto"`` may fuse on ``device``: only where the
    kernels are compiled, on the card. On the CPU the wrappers compute
    their plain versions, which are never faster than the unfused path,
    so "auto" resolves to "off" there ("on" still routes through the
    wrapper, for tests and parity runs).

    >>> backend_supports("cpu")
    False
    """
    return torch.device(device).type == "cuda"


def make_score_fn():
    """``SparsifierConfig.score_fn`` adapter: the CUDA score kernel in the
    dense-state simulator, one launch for all N workers' ``[N, L]``
    vectors. The simulator fuses the scoring stage only (4 reads and 1
    write instead of about a dozen streams); the select→encode fusion
    needs the compact state of the trainer."""
    from repro_torch.kernels import ops

    def score_fn(a, a_prev, s_prev, g_prev, cfg):
        return ops.regtopk_score(
            a, a_prev, s_prev, g_prev.expand_as(a),
            omega=cfg.omega, mu=cfg.mu, q=cfg.q_const, y=cfg.y,
        )

    return score_fn


def fused_hbm_bytes(length: int, k: int, m=None) -> int:
    """Device-memory traffic of the fused pipeline for one worker: four f32
    reads over the padded tiles, the candidate triples and the k-payload
    write.

    >>> fused_hbm_bytes(65536, 64)
    1051776
    """
    tiles = _n_tiles(length)
    m = candidate_budget(length, k) if m is None else m
    return 16 * tiles * _TILE + 12 * tiles * m + 8 * k


def fused_compact_select(scfg, st, g: torch.Tensor, k: int, *, counts=None):
    """Fused replacement for ``compact.compact_select`` on fusable configs,
    for all W workers at once. Returns the same ``(a, vals, idx)``.

    The compact posterior statistics are scattered to the dense layout the
    kernel reads, one launch scores and selects every worker's candidates,
    and each worker whose certificate fails (or, for regtopk with y != 1,
    whose round is 0) gets its payload from the dense path instead — the
    counterpart of the JAX package's ``lax.cond``. The payload is the dense
    path's either way; the certificate decides which computed it."""
    from repro_torch.core import compact as C
    from repro_torch.kernels import ops

    a = st.eps + g.to(st.eps.dtype)
    W, L = a.shape
    zeros = torch.zeros_like(a)
    y = scfg.y
    if scfg.kind == "regtopk":
        # t == 0 scatters an all-zero s_prev: every coordinate takes the
        # unsent branch and the score is |a|^y, plain Top-k's order only
        # when y == 1 (x^y can merge 1-ulp-apart magnitudes into ties).
        live = (st.t > 0).to(a.dtype)[:, None].expand(W, k)
        s_prev = zeros.scatter(1, st.sent_idx, live)
        a_prev = zeros.scatter(1, st.sent_idx, st.sent_vals)
        g_prev = zeros.scatter(1, st.sent_idx, st.sent_g)
    else:  # topk scores plain |a|: an all-zero state and y = 1
        s_prev = a_prev = g_prev = zeros
        y = 1.0
    vals, idx, ok = ops.fused_select_encode(
        a, a_prev, s_prev, g_prev,
        k=k, omega=scfg.omega, mu=scfg.mu, q=scfg.q_const, y=y,
        m=candidate_budget(L, k),
    )
    if scfg.kind == "regtopk" and y != 1.0:
        ok = ok & (st.t > 0)
    failed = torch.nonzero(~ok)[:, 0]
    n_failed = int(failed.numel())
    if counts is not None:
        counts.rounds += W
        counts.fallbacks += n_failed
    if n_failed:
        _, dvals, didx = C.compact_select(
            scfg, C.select_rows(st, failed), g[failed], k
        )
        vals[failed] = dvals.to(vals.dtype)
        idx[failed] = didx
    return a, vals.to(a.dtype), idx
