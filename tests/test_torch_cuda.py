"""Device routing of the port's kernel wrappers, and the tests that need an
NVIDIA card (marker ``cuda``; they skip without one).

This file imports neither ``jax`` nor ``repro``, so it also runs on a
machine that has only the port's dependencies:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import fused_encode as fe
from repro_torch.kernels import ops

KW = dict(omega=0.125, mu=1.0, q=1e9, m=16)


def _tiles(device, W=3, n=3 * 8192 + 17, seed=5, nan=None):
    """Worker-batched tiles; ``nan`` puts one NaN ("one") or only NaN
    ("tile") into tile 1 of worker 1's gradient."""
    rng = np.random.default_rng(seed)
    xs = [
        3.0 * rng.standard_normal((W, n)),
        3.0 * rng.standard_normal((W, n)),
        rng.random((W, n)) > 0.5,
        3.0 * rng.standard_normal((W, n)),
    ]
    if nan == "one":
        xs[0][1, 8192 + 5] = np.nan
    elif nan == "tile":
        xs[0][1, 8192:16384] = np.nan
    return [
        ops._tile(torch.tensor(x, dtype=torch.float32, device=device))[0]
        for x in xs
    ]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: a CUDA kernel has no CPU mode")


def test_cpu_tensor_takes_the_plain_version():
    xs = _tiles("cpu")
    before = fe.fused_candidates.launches
    got = fe.fused_candidates(*xs, y=1.0, **KW)
    want = fe.fused_candidates_ref(*xs, y=1.0, **KW)
    assert fe.fused_candidates.launches == before
    for g, w in zip(got, want, strict=True):
        assert torch.equal(g, w)


def test_other_devices_raise():
    x = torch.zeros(1, 8, 1024, device="meta")
    with pytest.raises(ValueError, match="no fused_candidates kernel"):
        fe.fused_candidates(x, x, x, x, y=1.0, **KW)


@pytest.mark.cuda
@pytest.mark.parametrize("nan", [None, "one", "tile"])
@pytest.mark.parametrize("y", [1.0, 2.0])
def test_kernel_matches_plain_version_bit_for_bit(card, y, nan):
    xs = _tiles("cuda", nan=nan)
    before = fe.fused_candidates.launches
    got = fe.fused_candidates(*xs, y=y, **KW)
    assert fe.fused_candidates.launches == before + 1
    want = fe.fused_candidates_ref(*xs, y=y, **KW)
    torch.cuda.synchronize()
    for g, w in zip(got, want, strict=True):
        torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)
    if nan is not None:
        assert torch.isnan(got[0][1, 1]).all()
