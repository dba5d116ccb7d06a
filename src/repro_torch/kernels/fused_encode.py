"""Fused select→encode: per-tile RegTop-k candidates straight from the
score (counterpart of ``repro.kernels.fused_encode``).

For every 8192-element tile of every worker's gradient, the kernel
computes the Alg. 2 score ``|a|^y * tanh(|1 + Delta| / mu)`` in the tile
and emits its top-``m`` (score, a-value, flat index) triples, ties going
to the lowest flat index. The dense score never reaches device memory.
:func:`select_from_candidates` then takes the exact top-k over the
``[nblk, m]`` candidates and checks the exactness certificate; where it
fails, the caller falls back to dense selection
(``repro_torch.comm.fastpath.fused_compact_select``).

:func:`fused_candidates` launches the CUDA kernel
(``csrc/fused_encode.cu``) for a tensor on the card and computes
:func:`fused_candidates_ref`, its plain PyTorch version, for a tensor on
the CPU. It counts its launches in ``fused_candidates.launches``.
"""
from __future__ import annotations

import ctypes
import torch

from repro_torch.core.selectors import topk_stable
from repro_torch.kernels.block_topk import masked_max_edges
from repro_torch.kernels.regtopk_score import TILE, check_tiles, score_chain


def fused_candidates_ref(a, a_prev, s_prev, g_prev, *, omega, mu, q=1e9,
                         y=1.0, m=16):
    """Plain PyTorch version of the kernel on ``[W, rows, 1024]`` tiles.

    m rounds of a masked max with the lowest-index tie break emit a tile's
    scores in descending order, equal scores in index order: the first m
    entries of a stable descending sort of the tile, with the edges of
    ``block_topk.masked_max_edges``. The a-value is the masked sum
    ``sum(where(onehot, a, 0))``, which turns -0.0 into +0.0: hence
    ``+ 0.0``. A tile that holds a NaN score emits ``(NaN, 0, INT32_MAX)``
    in every round, as the TPU kernel does (its max is NaN and no element
    equals it), so the certificate fails and the dense path answers."""
    W, nblk = check_tiles(a, a_prev, s_prev, g_prev)
    score = score_chain(
        a, a_prev, s_prev, g_prev, omega=omega, mu=mu, q=q, y=y
    ).reshape(W, nblk, TILE)
    cs, pos = topk_stable(score, m)
    cs, ci = masked_max_edges(cs, pos, score)
    base = torch.arange(nblk, device=a.device)[None, :, None] * TILE
    cv = torch.gather(a.reshape(W, nblk, TILE), 2, ci.long() - base) + 0.0
    nan_tile = torch.isnan(score).any(dim=2, keepdim=True)
    return (
        cs.masked_fill(nan_tile, float("nan")),
        cv.masked_fill(nan_tile, 0.0),
        ci.masked_fill(nan_tile, torch.iinfo(torch.int32).max),
    )


_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_float] * 4 + [
    ctypes.c_void_p
]


def fused_candidates(a, a_prev, s_prev, g_prev, *, omega, mu, q=1e9, y=1.0,
                     m=16):
    """All inputs ``[W, rows, 1024]`` f32. Returns per-tile candidate
    triples ``(scores [W, nblk, m], values [W, nblk, m], flat idx [W, nblk,
    m] int32)`` with ``nblk = rows // 8``: one CTA per (worker, tile), one
    launch for all W workers."""
    W, nblk = check_tiles(a, a_prev, s_prev, g_prev)
    if not 1 <= m <= TILE:
        raise ValueError(f"candidate budget m={m} outside [1, {TILE}]")
    if a.device.type == "cpu":
        return fused_candidates_ref(
            a, a_prev, s_prev, g_prev, omega=omega, mu=mu, q=q, y=y, m=m
        )
    if a.device.type != "cuda":
        raise ValueError(f"no fused_candidates kernel for {a.device}")
    from repro_torch.kernels import build

    lib = build.load("fused_encode")
    fn = lib.fused_candidates_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    cs = torch.empty((W, nblk, m), dtype=torch.float32, device=a.device)
    cv = torch.empty_like(cs)
    ci = torch.empty((W, nblk, m), dtype=torch.int32, device=a.device)
    with torch.cuda.device(a.device):
        err = fn(
            a.data_ptr(), a_prev.data_ptr(), s_prev.data_ptr(),
            g_prev.data_ptr(), cs.data_ptr(), cv.data_ptr(), ci.data_ptr(),
            W, nblk, m, omega, mu, q, y,
            torch.cuda.current_stream(a.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"fused_candidates launch failed: CUDA error {err}")
    fused_candidates.launches += 1
    return cs, cv, ci


fused_candidates.launches = 0


def select_from_candidates(cand_score, cand_val, cand_idx, k: int):
    """Compact ``[W, nblk, m]`` candidates into each worker's fixed-k
    payload. Returns ``(vals [W, k], idx [W, k] int64, ok [W])``.

    The top-k over the flattened candidates (tile-major, rank-minor, which
    is flat-index order under ties) is the dense stable top-k provided the
    certificate holds: every tile's m-th candidate is below the k-th
    selected score tau. With one tile the candidates are the exact top-m,
    so any tau > 0 certifies. tau == 0 never certifies: zero scores are
    never selected, which also keeps padding indices out of the payload."""
    W, nblk, m = cand_score.shape
    k = int(k)
    if k > nblk * m:
        raise ValueError(
            f"k={k} exceeds the candidate budget {nblk}x{m}; the caller "
            "should have routed this leaf to the unfused path"
        )
    top_s, pos = topk_stable(cand_score.reshape(W, -1), k)
    tau = top_s[:, k - 1]
    vals = torch.gather(cand_val.reshape(W, -1), 1, pos) * (top_s > 0)
    idx = torch.gather(cand_idx.reshape(W, -1), 1, pos).long()
    if nblk == 1:
        ok = tau > 0
    else:
        ok = (cand_score[:, :, m - 1] < tau[:, None]).all(dim=1)
    return vals, idx, ok
