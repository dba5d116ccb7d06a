"""Device routing of the port's kernel wrappers, and the tests that need an
NVIDIA card (marker ``cuda``; they skip without one).

This file imports neither ``jax`` nor ``repro``, so it also runs on a
machine that has only the port's dependencies:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import DistributedSim, SparsifierConfig
from repro_torch.kernels import fused_encode as fe
from repro_torch.kernels import ops
from repro_torch.kernels import regtopk_score as rs

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


def _unaligned(t):
    """A contiguous copy of ``t`` starting 4 bytes past a 16-byte boundary
    (the kernel's scalar loop)."""
    view = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:]
    return view.view_as(t).copy_(t)


@pytest.mark.cuda
@pytest.mark.parametrize("nan,aligned", [(None, True), ("one", True), (None, False)])
@pytest.mark.parametrize("y", [1.0, 2.0])
def test_score_kernel_matches_plain_version_bit_for_bit(card, y, nan, aligned):
    xs = _tiles("cuda", nan=nan)
    if not aligned:
        xs = [_unaligned(x) for x in xs]
        assert xs[0].data_ptr() % 16 == 4 and xs[0].is_contiguous()
    kw = dict(omega=0.125, mu=1.0, q=1e9, y=y)
    before = rs.regtopk_score.launches
    got = rs.regtopk_score(*xs, **kw)
    assert rs.regtopk_score.launches == before + 1
    want = rs.regtopk_score_ref(*xs, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
    assert torch.isnan(got).any() == (nan is not None)


@pytest.mark.cuda
def test_simulator_fastpath_on_equals_off_on_the_card(card):
    """RegTop-k with the score kernel and with the plain chain: the same
    masks and the same model, bit for bit, one launch per round."""
    rng = np.random.default_rng(0)
    X = torch.tensor(rng.standard_normal((4, 50, 300)), dtype=torch.float32,
                     device="cuda")
    yv = torch.tensor(rng.standard_normal((4, 50)), dtype=torch.float32,
                      device="cuda")

    def grad_fn(theta, widx):
        r = torch.einsum("ndj,j->nd", X[widx], theta) - yv[widx]
        return torch.einsum("ndj,nd->nj", X[widx], r) / 25.0

    out = {}
    for mode in ("off", "on"):
        sim = DistributedSim(grad_fn, 4, 300,
                             SparsifierConfig(kind="regtopk", sparsity=0.1, mu=4.0),
                             aggregation="sparse_allgather", fastpath=mode)
        before = rs.regtopk_score.launches
        out[mode] = sim.run(torch.zeros(300), 30,
                            trace_state_fn=lambda s: s.worker_states.s_prev)
        launched = rs.regtopk_score.launches - before
        assert launched == (30 if mode == "on" else 0)
    assert torch.equal(out["on"][1], out["off"][1])
    assert torch.equal(out["on"][0].theta, out["off"][0].theta)
