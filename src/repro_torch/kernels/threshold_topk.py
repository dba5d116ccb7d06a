"""Sort-free top-k mask by bisection on a threshold (counterpart of
``repro.kernels.threshold_topk``).

An exact top-k over a gradient-sized score sorts it. Gradient-compression
systems (DGC, ScaleCom) find a threshold instead: ``tau`` with ``count(score
>= tau) >= k``, by halving ``[0, max(score)]``. Each halving is one
streaming pass, and the kernels (``csrc/threshold_topk.cu``) make it:

* :func:`count_above` — ``#{score >= tau}`` per worker, ``tau`` read from
  the device;
* :func:`global_max`  — ``max(score)`` per worker, the first bracket, NaN
  if the score holds one (as ``jnp.max``).

:func:`threshold_topk_mask` is the bisection: plain PyTorch on 0-d-per-
worker device tensors, so its ``n_iters`` launches are queued without a
host sync. It computes ``mid = 0.5 * (lo + hi)`` and the two ``where``
updates as the JAX driver does, so the mask equals
``repro_torch.core.selectors.threshold_topk_mask``'s for ``0 < k < L``
(the zero padding counts only at ``tau <= 0``, where both agree).

Each wrapper launches its CUDA kernel for a tensor on the card, computes
its plain version (``*_ref``) for a tensor on the CPU, and counts its
launches in ``<wrapper>.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.regtopk_score import check_tiles


def count_above_ref(tiles: torch.Tensor, tau: torch.Tensor) -> torch.Tensor:
    """Plain version: ``[W]`` int32 counts of ``tiles[w] >= tau[w]``."""
    return (tiles >= tau[:, None, None]).sum(dim=(1, 2), dtype=torch.int32)


def global_max_ref(tiles: torch.Tensor) -> torch.Tensor:
    """Plain version: ``[W]`` f32 maxima, NaN where a worker's tiles hold
    one."""
    return torch.amax(tiles, dim=(1, 2))


def _bisect(tiles, k, n_iters, count, top):
    lo = torch.zeros_like(top)
    hi = top
    for _ in range(n_iters):
        mid = 0.5 * (lo + hi)
        ok = count(tiles, mid) >= k
        lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
    # zero scores carry no gradient and are never selected: an all-zero
    # score gives an empty mask, not an all-ones one
    lo = lo[:, None, None]
    return ((tiles >= lo) & (tiles > 0)).to(tiles.dtype)


def threshold_topk_mask_ref(tiles: torch.Tensor, k: int,
                            n_iters: int = 24) -> torch.Tensor:
    """Plain version of the whole selection on ``[W, rows, 1024]`` f32
    tiles (``repro.kernels.ref.threshold_topk_mask_ref`` per worker)."""
    check_tiles(tiles)
    return _bisect(tiles, int(k), n_iters, count_above_ref, global_max_ref(tiles))


# (tiles, elements per worker, workers, tau or scratch, out, stream)
_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]


def _lib(tiles: torch.Tensor, name: str):
    if tiles.device.type != "cuda":
        raise ValueError(f"no {name} kernel for {tiles.device}")
    from repro_torch.kernels import build

    return build.load("threshold_topk")


def _check_err(err: int, name: str) -> None:
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def count_above(tiles: torch.Tensor, tau: torch.Tensor) -> torch.Tensor:
    """``tiles [W, rows, 1024]`` f32, ``tau [W]`` f32 on the same device →
    ``[W]`` int32 counts of ``tiles[w] >= tau[w]``. One launch for all
    workers; ``tau`` is read on the device."""
    W, _ = check_tiles(tiles)
    if tau.shape != (W,) or tau.dtype != torch.float32 or tau.device != tiles.device:
        raise ValueError(f"tau must be [{W}] f32 on {tiles.device}")
    if tiles.device.type == "cpu":
        return count_above_ref(tiles, tau)
    fn = _lib(tiles, "count_above").count_above_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    tau = tau.contiguous()
    out = torch.empty(W, dtype=torch.int32, device=tiles.device)
    with torch.cuda.device(tiles.device):
        err = fn(tiles.data_ptr(), tiles[0].numel(), W, tau.data_ptr(),
                 out.data_ptr(),
                 torch.cuda.current_stream(tiles.device).cuda_stream)
    _check_err(err, "count_above")
    count_above.launches += 1
    return out


count_above.launches = 0


def global_max(tiles: torch.Tensor) -> torch.Tensor:
    """``tiles [W, rows, 1024]`` f32 → ``[W]`` f32 maxima (NaN where a
    worker's tiles hold a NaN). One launch for all workers."""
    W, _ = check_tiles(tiles)
    if tiles.device.type == "cpu":
        return global_max_ref(tiles)
    fn = _lib(tiles, "global_max").global_max_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    scratch = torch.empty(2 * W, dtype=torch.int32, device=tiles.device)
    out = torch.empty(W, dtype=torch.float32, device=tiles.device)
    with torch.cuda.device(tiles.device):
        err = fn(tiles.data_ptr(), tiles[0].numel(), W, scratch.data_ptr(),
                 out.data_ptr(),
                 torch.cuda.current_stream(tiles.device).cuda_stream)
    _check_err(err, "global_max")
    global_max.launches += 1
    return out


global_max.launches = 0


def threshold_topk_mask(tiles: torch.Tensor, k: int, n_iters: int = 24) -> torch.Tensor:
    """~k-cardinality ``{0, 1}`` f32 mask of ``[W, rows, 1024]`` f32 tiles,
    one bisection per worker: one :func:`global_max` launch and
    ``n_iters`` :func:`count_above` launches, none waiting on the host.
    The mask holds the exact top-k, and more on ties or an unconverged
    bracket; zero scores are never in it."""
    check_tiles(tiles)
    return _bisect(tiles, int(k), n_iters, count_above, global_max(tiles))
