"""Fused select→encode fastpath: fusability, candidate budget, pricing
and runtime routing (counterpart of ``repro.comm.fastpath``).

The trainer takes the modes ``"on"`` (fuse every fusable leaf),
``"off"`` and ``"auto"``: fuse the leaves that :class:`ThroughputTable`
prices faster fused, and only on the card (:func:`backend_supports`);
:func:`leaf_fused` makes the per-leaf decision. The simulator fuses only
its scoring stage (:func:`make_score_fn`) and resolves ``"auto"`` by
:func:`backend_supports`.
"""
from __future__ import annotations

import dataclasses
import math
import statistics
import time
from typing import Optional, Tuple

import torch

from repro_torch.comm.codec import Codec, get_codec

FASTPATH_MODES = ("off", "on", "auto")

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


def wire_fusable(codec, collective: str) -> Tuple[bool, str]:
    """The codec (an object or a name) must have a fused epilogue and the
    collective must move payloads: ``bitmap_dense``'s wire format is the
    dense bitmap the fastpath never builds, and ``dense_allreduce`` moves
    the dense vector.

    >>> wire_fusable("coo_fp32", "sparse_allgather")[0]
    True
    >>> wire_fusable("bitmap_dense", "sparse_allgather")[0]
    False
    >>> wire_fusable("coo_q8", "dense_allreduce")[0]
    False
    """
    c = codec if isinstance(codec, Codec) else get_codec(codec)
    if not c.supports_fused:
        return False, f"codec {c.name!r} has no encode_fused epilogue"
    if collective == "dense_allreduce":
        return False, "dense_allreduce moves the dense vector, not payloads"
    return True, "ok"


# kernel 1 writes each candidate's flat index as an int32
# (csrc/fused_encode.cu), so a leaf must have fewer elements than this
MAX_FUSED_LEN = 2**31


def shape_fusable(length: int, k: int) -> Tuple[bool, str]:
    """``k`` must fit in ``n_tiles * m`` candidates, and every flat index
    of the leaf in an int32 (fewer than ``MAX_FUSED_LEN`` elements): a
    longer leaf stays unfused, where its indices are int64.

    >>> shape_fusable(65536, 64)[0]
    True
    >>> shape_fusable(8192, 1024)[0]
    False
    >>> shape_fusable(2**31, 2**21)[1]
    'a 2147483648-element leaf has flat indices beyond int32'
    """
    if length >= MAX_FUSED_LEN:
        return False, (
            f"a {length}-element leaf has flat indices beyond int32"
        )
    m = candidate_budget(length, k)
    if k > _n_tiles(length) * m:
        return False, (
            f"k={k} exceeds the {_n_tiles(length)}x{m} candidate budget"
        )
    return True, "ok"


def fusable(scfg, codec, collective: str, length: int, k: int):
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
    write. The padding term is why a tiny leaf prices worse fused.

    >>> fused_hbm_bytes(65536, 64)
    1051776
    >>> fused_hbm_bytes(100, 4) > unfused_hbm_bytes(100, 4)
    True
    """
    tiles = _n_tiles(length)
    m = candidate_budget(length, k) if m is None else m
    return 16 * tiles * _TILE + 12 * tiles * m + 8 * k


def unfused_hbm_bytes(length: int, k: int) -> int:
    """Device-memory traffic of the unfused chain for one worker: the
    score's four reads and one write, the selector's re-read and the
    payload gather, 24 bytes an element and 8 a coordinate.

    >>> unfused_hbm_bytes(65536, 64)
    1573376
    """
    return 24 * length + 8 * k


# Kernel 2 (csrc/regtopk_score.cu) streams the full-width score at
# 2.93e12-2.98e12 B/s on an NVIDIA H100 80GB HBM3 at a 700 W power limit
# (chip_smoke.py's score phase). Both defaults take that rate, so the
# default table decides on the bytes alone.
DEFAULT_BPS = 2.98e12


@dataclasses.dataclass(frozen=True)
class ThroughputTable:
    """Effective throughput of the two select→encode paths, which prices
    ``fastpath="auto"``: ``seconds(length, k, fused)`` divides a path's
    bytes by its rate. With the equal defaults the fused path wins
    wherever it moves fewer bytes; :meth:`measure` refits both rates from
    timings."""

    fused_bps: float = DEFAULT_BPS
    unfused_bps: float = DEFAULT_BPS

    def seconds(self, length: int, k: int, fused: bool) -> float:
        if fused:
            return fused_hbm_bytes(length, k) / self.fused_bps
        return unfused_hbm_bytes(length, k) / self.unfused_bps

    def prefers_fused(self, length: int, k: int) -> bool:
        return self.seconds(length, k, True) < self.seconds(length, k, False)

    @classmethod
    def measure(cls, length: int = 1 << 16, k: int = 64, iters: int = 3,
                device="cuda") -> "ThroughputTable":
        """Fit each path's rate from host-clock timings on ``device`` of
        one worker's leaf of ``length``: the fused kernel 1 pipeline
        (``ops.fused_select_encode``) against the dense chain that
        ``compact_select`` runs with the fastpath off (the score, the
        stable top-k, the gather). On the CPU the fused side is the
        kernel's plain version, which the table then prices slower."""
        from repro_torch.core.selectors import topk_stable
        from repro_torch.kernels import ops
        from repro_torch.kernels.regtopk_score import score_chain

        gen = torch.Generator().manual_seed(0)
        a, a_prev, g_prev = (
            (3.0 * torch.randn((1, length), generator=gen)).to(device)
            for _ in range(3)
        )
        s_prev = (torch.rand((1, length), generator=gen) > 0.5).float().to(device)
        kw = dict(omega=0.05, mu=1.0, q=1e9, y=1.0)
        cuda = torch.device(device).type == "cuda"

        def fused():
            return ops.fused_select_encode(
                a, a_prev, s_prev, g_prev, k=k,
                m=candidate_budget(length, k), **kw,
            )

        def unfused():
            score = score_chain(a, a_prev, s_prev, g_prev, **kw)
            _, idx = topk_stable(score, k)
            live = torch.gather(score, 1, idx) > 0
            return torch.where(live, torch.gather(a, 1, idx), 0.0), idx

        def med_seconds(fn):
            fn()
            times = []
            for _ in range(iters):
                if cuda:
                    torch.cuda.synchronize(device)
                t0 = time.perf_counter()
                fn()
                if cuda:
                    torch.cuda.synchronize(device)
                times.append(time.perf_counter() - t0)
            return max(statistics.median(times), 1e-9)

        return cls(
            fused_bps=fused_hbm_bytes(length, k) / med_seconds(fused),
            unfused_bps=unfused_hbm_bytes(length, k) / med_seconds(unfused),
        )


def leaf_fused(mode: str, codec, collective: str, length: int, k: int,
               table: Optional[ThroughputTable] = None, scfg=None) -> bool:
    """One leaf's fused flag under ``mode``: never for a wire or shape
    (or, when ``scfg`` is given, a config) that cannot fuse; always for
    ``"on"``; priced by ``table`` (its defaults when None) for
    ``"auto"``.

    >>> leaf_fused("on", "coo_fp32", "sparse_allgather", 65536, 64)
    True
    >>> leaf_fused("auto", "coo_fp32", "sparse_allgather", 100, 4)
    False
    >>> leaf_fused("on", "bitmap_dense", "sparse_allgather", 65536, 64)
    False
    """
    if mode not in FASTPATH_MODES:
        raise ValueError(
            f"unknown fastpath mode {mode!r}; available: {FASTPATH_MODES}"
        )
    if mode == "off":
        return False
    if scfg is not None and not config_fusable(scfg)[0]:
        return False
    if not (wire_fusable(codec, collective)[0] and shape_fusable(length, k)[0]):
        return False
    if mode == "on":
        return True
    return (table or ThroughputTable()).prefers_fused(length, k)


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
    # the dense scatters are W copies of the leaf: let them go before the
    # fallback, which builds its own for the failed rows
    del zeros, s_prev, a_prev, g_prev
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
