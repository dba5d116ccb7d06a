"""The RegTop-k selection metric as one elementwise pass (counterpart of
``repro.kernels.regtopk_score``).

The Alg. 2 score ``|a|^y * tanh(|1 + Delta| / mu)`` reads four
gradient-sized streams and writes one. Unfused, PyTorch runs it as about
twelve elementwise operators, each streaming gradient-sized tensors
through device memory; the kernel (``csrc/regtopk_score.cu``) makes one
pass. Both evaluate :func:`score_chain` op for op, so on the card the
kernel equals its plain version bit for bit and the simulator's fastpath
on and off runs agree exactly.

:func:`regtopk_score` launches the CUDA kernel for a tensor on the card
and computes :func:`regtopk_score_ref`, its plain PyTorch version, for a
tensor on the CPU. It counts its launches in ``regtopk_score.launches``.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

LANES = 1024
SUBLANES = 8
TILE = SUBLANES * LANES


def pow_y(mag: torch.Tensor, y: float) -> torch.Tensor:
    """``mag ** y`` as the kernels compute it: no pow for y == 1, one
    multiply for y == 2, else an elementwise ``powf``."""
    if y == 1.0:
        return mag
    if y == 2.0:
        return mag * mag
    return torch.pow(mag, torch.full_like(mag, y))


def ieee_div(x: torch.Tensor, c: float) -> torch.Tensor:
    # IEEE division by a device tensor: PyTorch's CUDA divide multiplies
    # by the reciprocal when the divisor is a Python scalar.
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def const_div(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` for a constant ``c`` as the JAX package computes it under
    ``jax.jit``: XLA rewrites the division as a product with the float32
    reciprocal ``fl(1/c)``, which differs from the IEEE quotient in the
    last bit unless ``c`` is a power of two.

    >>> x = torch.tensor([1.0, 10.0])
    >>> bool((const_div(x, 4.0) == x / 4).all())
    True
    """
    return x * float(np.float32(1.0) / np.float32(c))


def ordered_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean over the first axis of ``x`` (a few workers) as XLA:CPU
    reduces it under ``jax.jit`` (``.mean()``, ``pmean``): summed in index
    order, then times the float32 reciprocal of the count
    (:func:`const_div`)."""
    total = x[0]
    for i in range(1, x.shape[0]):
        total = total + x[i]
    return const_div(total, float(x.shape[0]))


def score_chain(a, a_prev, s_prev, g_prev, *, omega, mu, q, y):
    """The Alg. 2 selection metric, op for op as ``csrc/score_chain.cuh``
    computes it (and as ``repro.kernels.regtopk_score.score_chain``).
    ``omega`` is a scalar, or, on this plain path only, an ``[L]`` tensor
    (coordinate weighting)."""
    denom = omega * a
    safe = torch.where(denom == 0.0, 1.0, denom)
    delta_sent = (g_prev - omega * a_prev) / safe
    delta = torch.where(s_prev > 0.0, delta_sent, q)
    reg = torch.tanh(ieee_div(torch.abs(1.0 + delta), mu))
    return pow_y(torch.abs(a), y) * reg


def regtopk_score_ref(a, a_prev, s_prev, g_prev, *, omega, mu, q=1e9, y=1.0):
    """Plain PyTorch version of the kernel: the chain on same-shaped f32
    tensors."""
    return score_chain(a, a_prev, s_prev, g_prev, omega=omega, mu=mu, q=q, y=y)


def check_tiles(*xs: torch.Tensor) -> Tuple[int, int]:
    """Validate ``[W, rows, 1024]`` f32 tiles; returns (W, tiles per
    worker)."""
    if xs[0].dim() != 3:
        raise ValueError(
            f"expected [W, rows, {LANES}] tiles, got {tuple(xs[0].shape)}"
        )
    _, rows, lanes = xs[0].shape
    if lanes != LANES or rows % SUBLANES:
        raise ValueError(
            f"expected [W, rows, {LANES}] tiles with rows % {SUBLANES} == 0,"
            f" got {tuple(xs[0].shape)}"
        )
    for x in xs:
        if x.shape != xs[0].shape or x.dtype != torch.float32:
            raise ValueError("inputs must share one [W, rows, 1024] f32 shape")
        if x.device != xs[0].device or not x.is_contiguous():
            raise ValueError("inputs must be contiguous on one device")
    return xs[0].shape[0], rows // SUBLANES


_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [ctypes.c_float] * 4 + [
    ctypes.c_void_p
]


def regtopk_score(a, a_prev, s_prev, g_prev, *, omega, mu, q=1e9, y=1.0):
    """All inputs ``[W, rows, 1024]`` f32; returns the score, same shape.
    One launch covers all W workers."""
    check_tiles(a, a_prev, s_prev, g_prev)
    if a.device.type == "cpu":
        return regtopk_score_ref(
            a, a_prev, s_prev, g_prev, omega=omega, mu=mu, q=q, y=y
        )
    if a.device.type != "cuda":
        raise ValueError(f"no regtopk_score kernel for {a.device}")
    from repro_torch.kernels import build

    lib = build.load("regtopk_score")
    fn = lib.regtopk_score_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    out = torch.empty_like(a)
    with torch.cuda.device(a.device):
        err = fn(
            a.data_ptr(), a_prev.data_ptr(), s_prev.data_ptr(),
            g_prev.data_ptr(), out.data_ptr(), a.numel(),
            omega, mu, q, y,
            torch.cuda.current_stream(a.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"regtopk_score launch failed: CUDA error {err}")
    regtopk_score.launches += 1
    return out


regtopk_score.launches = 0
