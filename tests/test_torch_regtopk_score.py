"""The port's RegTop-k score pass against the JAX package's.

``repro_torch.kernels.ops.regtopk_score`` on CPU tensors (its wrapper
then computes the plain version, ``regtopk_score_ref``, on the padded
tiles) is held against ``repro.kernels.ops.regtopk_score(...,
interpret=True)``, the Pallas kernel in interpret mode, on the same numpy
inputs, one JAX call per worker. Scores agree to rtol 1e-6: XLA:CPU's and
PyTorch's tanh and pow differ in the last ulp.
"""
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.core.sparsify import DenseState, RegTopK, SparsifierConfig
from repro_torch.kernels import ops as tops
from repro_torch.kernels import regtopk_score as rs

RTOL = 1e-6
OMEGA, MU, Q = 0.25, 1.5, 1e9
W = 2


def _inputs(n, seed, case="mixed"):
    """``[W, n]`` f32 inputs. "mixed": s_prev half ones; "zero denominators":
    a == 0 where s_prev > 0 on a tenth of the coordinates; "unsent":
    s_prev all zero (every coordinate takes the Q branch); "nan": one NaN
    gradient entry per worker."""
    rng = np.random.default_rng(seed)
    a = (3.0 * rng.standard_normal((W, n))).astype(np.float32)
    a_prev = (3.0 * rng.standard_normal((W, n))).astype(np.float32)
    s_prev = (rng.random((W, n)) > 0.5).astype(np.float32)
    g_prev = (3.0 * rng.standard_normal((W, n))).astype(np.float32)
    if case == "zero denominators":
        zero = rng.random((W, n)) < 0.1
        a[zero] = 0.0
        s_prev[zero] = 1.0
    elif case == "unsent":
        s_prev[:] = 0.0
    elif case == "nan":
        a[:, 5] = np.nan
    return a, a_prev, s_prev, g_prev


def _jax_score(xs, y):
    return np.stack([
        np.asarray(jops.regtopk_score(
            *(x[w] for x in xs), omega=OMEGA, mu=MU, q=Q, y=y, interpret=True
        ))
        for w in range(W)
    ])


@pytest.mark.parametrize("y", [1.0, 2.0, 1.5])
@pytest.mark.parametrize("n", [1, 8192, 3 * 8192 + 17, 5 * 8192])
def test_score_matches_jax(n, y):
    xs = _inputs(n, seed=n)
    got = tops.regtopk_score(
        *(torch.from_numpy(x) for x in xs), omega=OMEGA, mu=MU, q=Q, y=y
    )
    assert got.shape == (W, n) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _jax_score(xs, y), rtol=RTOL)


@pytest.mark.parametrize("case", ["zero denominators", "unsent", "nan"])
@pytest.mark.parametrize("y", [1.0, 2.0])
def test_edge_cases_match_jax(case, y):
    xs = _inputs(2 * 8192 + 3, seed=7, case=case)
    got = tops.regtopk_score(
        *(torch.from_numpy(x) for x in xs), omega=OMEGA, mu=MU, q=Q, y=y
    )
    want = _jax_score(xs, y)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL)
    if case == "unsent":
        # tanh((1 + Q) / mu) is 1.0 in float32: the score is |a|^y
        mag = np.abs(xs[0]) ** y if y != 1.0 else np.abs(xs[0])
        np.testing.assert_allclose(got.numpy(), mag, rtol=RTOL)
    elif case == "nan":
        assert np.isnan(got.numpy()[:, 5]).all()
        assert np.isfinite(np.delete(got.numpy(), 5, axis=1)).all()
    else:
        assert (got.numpy()[xs[0] == 0.0] == 0.0).all()


@pytest.mark.parametrize("y", [1.0, 2.0, 1.5])
def test_dense_score_is_the_plain_kernel_chain(y):
    """RegTop-k's dense ``_score`` and the kernel's plain version are one
    chain: equal bit for bit on the same tensors."""
    a, a_prev, s_prev, g_prev = (
        torch.from_numpy(x) for x in _inputs(4099, seed=3)
    )
    sp = RegTopK(SparsifierConfig(kind="regtopk", mu=MU, y=y, omega=OMEGA))
    st = DenseState(eps=torch.zeros_like(a), a_prev=a_prev, s_prev=s_prev,
                    t=torch.ones(W, dtype=torch.int32))
    dense = sp._score(st, a, g_prev[0])
    ref = rs.regtopk_score_ref(
        a, a_prev, s_prev, g_prev[0].expand_as(a), omega=OMEGA, mu=MU, q=Q, y=y
    )
    assert torch.equal(dense, ref)


@pytest.mark.parametrize("n", [8192, 8192 + 5])
def test_broadcast_previous_aggregate(n):
    """The simulator hands every worker the same ``g_prev`` as an expanded
    ``[L]`` vector; at a whole number of tiles no padding copy makes it
    contiguous, so the layout contract must."""
    a, a_prev, s_prev, g_prev = (torch.from_numpy(x) for x in _inputs(n, seed=2))
    got = tops.regtopk_score(
        a, a_prev, s_prev, g_prev[0].expand_as(a), omega=OMEGA, mu=MU, q=Q
    )
    want = rs.regtopk_score_ref(
        a, a_prev, s_prev, g_prev[0].expand_as(a), omega=OMEGA, mu=MU, q=Q
    )
    assert torch.equal(got, want)


def test_cpu_tensor_takes_the_plain_version():
    xs = [tops._tile(torch.from_numpy(x))[0] for x in _inputs(8192 + 1, 9)]
    before = rs.regtopk_score.launches
    got = rs.regtopk_score(*xs, omega=OMEGA, mu=MU, y=2.0)
    assert rs.regtopk_score.launches == before
    assert torch.equal(got, rs.regtopk_score_ref(*xs, omega=OMEGA, mu=MU, y=2.0))


def test_other_devices_raise():
    x = torch.zeros(1, 8, 1024, device="meta")
    with pytest.raises(ValueError, match="no regtopk_score kernel"):
        rs.regtopk_score(x, x, x, x, omega=OMEGA, mu=MU)


def test_wrapper_rejects_bad_layout():
    x = torch.zeros(1, 12, 1024)
    with pytest.raises(ValueError, match="rows"):
        rs.regtopk_score(x, x, x, x, omega=OMEGA, mu=MU)
    with pytest.raises(ValueError, match="contiguous"):
        t = torch.zeros(1, 8, 2048)[:, :, :1024]
        rs.regtopk_score(t, t, t, t, omega=OMEGA, mu=MU)
