"""Per-tile top-m candidates and the hierarchical top-k built on them
(counterpart of ``repro.kernels.block_topk``).

Each 8192-element tile of the score emits its top-``m`` (value, flat index)
pairs, as m rounds of a masked max would (``csrc/block_topk.cu``, a radix
select of the m-th score and a sort of the m winners); the
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


def masked_max_edges(vals, pos, s):
    """Fix a stable descending top-m ``(vals, pos)`` of the tiles ``s``
    ``[W, nblk, TILE]`` to what m rounds of a masked max emit: ``(vals,
    flat idx int32)``.

    The masked max of a set holding +0.0 is +0.0, so a zero comes out as
    +0.0 while a +0.0 at or after its index is still in the tile, else as
    -0.0 (the sort ranks the two zeros by index, as the max's ``==``
    does); and once the scores above -inf are used up every element
    matches the max, so a -inf comes out at the tile's first index."""
    nblk, tile = s.shape[1], s.shape[2]
    local = torch.arange(tile, device=s.device)
    pos_zero = (s == 0) & ~torch.signbit(s)
    last_pz = torch.where(pos_zero, local, -1).amax(dim=2, keepdim=True)
    zero = torch.where(pos <= last_pz, torch.tensor(0.0, device=s.device),
                       torch.tensor(-0.0, device=s.device))
    vals = torch.where(vals == 0, zero, vals)
    base = torch.arange(nblk, device=s.device)[None, :, None] * tile
    idx = torch.where(vals == -torch.inf, base, base + pos).to(torch.int32)
    return vals, idx


def block_topk_candidates_ref(tiles: torch.Tensor, m: int = 8):
    """Plain version on ``[W, rows, 1024]`` f32 tiles: ``(vals [W, nblk,
    m] f32, flat idx [W, nblk, m] int32)``.

    The masked-max rounds emit a tile's scores in descending order, equal
    scores lowest index first: a stable descending sort, with the edges of
    :func:`masked_max_edges`. A tile that holds a NaN emits (NaN,
    INT32_MAX) in every round."""
    W, nblk = check_tiles(tiles)
    s = tiles.reshape(W, nblk, TILE)
    vals, pos = topk_stable(s, m)
    vals, idx = masked_max_edges(vals, pos, s)
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
