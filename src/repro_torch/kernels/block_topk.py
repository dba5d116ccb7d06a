"""Per-tile top-m candidates and the hierarchical top-k built on them
(counterpart of ``repro.kernels.block_topk``).

Each 8192-element tile of the score emits its top-``m`` (value, flat index)
pairs by m rounds of a masked max (``csrc/block_topk.cu``, no sort); the
exact top-k over the ``(rows / 8) * m`` candidates is then a problem about
a thousand times smaller. It is exact whenever no tile holds more than m
of the top-k (always for k <= m).

:func:`block_topk_candidates` launches the CUDA kernel for a tensor on the
card and computes :func:`block_topk_candidates_ref`, its plain version,
for a tensor on the CPU. It counts its launches in
``block_topk_candidates.launches``.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.core.selectors import topk_stable
from repro_torch.kernels.regtopk_score import TILE, check_tiles

INT32_MAX = torch.iinfo(torch.int32).max


def block_topk_candidates_ref(tiles: torch.Tensor, m: int = 8):
    """Plain version on ``[W, rows, 1024]`` f32 tiles: ``(vals [W, nblk,
    m] f32, flat idx [W, nblk, m] int32)``.

    The masked-max rounds emit a tile's scores in descending order, equal
    scores lowest index first: a stable descending sort. Two edges follow
    the TPU body: once a tile's scores above -inf are used up, every round
    finds the whole tile at -inf and emits (-inf, the tile's first index);
    a tile that holds a NaN emits (NaN, INT32_MAX) in every round."""
    W, nblk = check_tiles(tiles)
    s = tiles.reshape(W, nblk, TILE)
    vals, pos = topk_stable(s, m)
    base = torch.arange(nblk, device=tiles.device)[None, :, None] * TILE
    idx = torch.where(vals == -torch.inf, base, base + pos).to(torch.int32)
    nan_tile = torch.isnan(s).any(dim=2, keepdim=True)
    return (
        vals.masked_fill(nan_tile, float("nan")),
        idx.masked_fill(nan_tile, INT32_MAX),
    )


_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def block_topk_candidates(tiles: torch.Tensor, m: int = 8):
    """``tiles [W, rows, 1024]`` f32 → ``(vals [W, nblk, m] f32, flat idx
    [W, nblk, m] int32)`` with ``nblk = rows // 8``: one CTA per (worker,
    tile), one launch for all W workers."""
    W, nblk = check_tiles(tiles)
    if not 1 <= m <= TILE:
        raise ValueError(f"candidate budget m={m} outside [1, {TILE}]")
    if tiles.device.type == "cpu":
        return block_topk_candidates_ref(tiles, m)
    if tiles.device.type != "cuda":
        raise ValueError(f"no block_topk_candidates kernel for {tiles.device}")
    from repro_torch.kernels import build

    fn = build.load("block_topk").block_topk_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    vals = torch.empty((W, nblk, m), dtype=torch.float32, device=tiles.device)
    idx = torch.empty((W, nblk, m), dtype=torch.int32, device=tiles.device)
    with torch.cuda.device(tiles.device):
        err = fn(tiles.data_ptr(), vals.data_ptr(), idx.data_ptr(), W, nblk, m,
                 torch.cuda.current_stream(tiles.device).cuda_stream)
    if err:
        raise RuntimeError(f"block_topk_candidates launch failed: CUDA error {err}")
    block_topk_candidates.launches += 1
    return vals, idx


block_topk_candidates.launches = 0


def hierarchical_topk(tiles: torch.Tensor, k: int, m: int = 8
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k of each worker's tiles from the per-tile candidates: ``(vals
    [W, k], flat idx [W, k] int32)``, descending, ties lowest candidate
    first (as ``lax.top_k``). Raises ``ValueError`` when k exceeds the
    ``nblk * m`` candidates."""
    W, nblk = check_tiles(tiles)
    if k > nblk * m:
        raise ValueError(f"k={k} exceeds the {nblk}x{m} candidates; raise m")
    vals, idx = block_topk_candidates(tiles, m)
    top, pos = topk_stable(vals.reshape(W, -1), k)
    return top, torch.gather(idx.reshape(W, -1), 1, pos)
