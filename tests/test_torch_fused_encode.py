"""The port's fused select→encode pipeline against the JAX package's.

The port's plain version (``fused_candidates_ref``, which its wrapper
computes for a CPU tensor) and ``select_from_candidates`` are held against
``repro.kernels.fused_encode.fused_candidates(..., interpret=True)`` and
its ``select_from_candidates`` on the same numpy inputs. Indices and the
certificate must match exactly; scores and values agree to rtol 1e-6,
because XLA:CPU's and PyTorch's tanh and pow differ in the last ulp.
"""
import numpy as np
import pytest
import torch

from repro.kernels import fused_encode as jfe
from repro.kernels import ops as jops
from repro_torch.kernels import fused_encode as tfe
from repro_torch.kernels import ops as tops

RTOL = 1e-6
OMEGA, MU, Q = 0.05, 1.0, 1e9


def _inputs(n, seed):
    rng = np.random.default_rng(seed)
    a = (3.0 * rng.standard_normal(n)).astype(np.float32)
    a_prev = (3.0 * rng.standard_normal(n)).astype(np.float32)
    s_prev = (rng.random(n) > 0.5).astype(np.float32)
    g_prev = (3.0 * rng.standard_normal(n)).astype(np.float32)
    return a, a_prev, s_prev, g_prev


def _both(xs, k, m, y):
    """Run both stacks; returns ((cand triples), (vals, idx, ok)) each."""
    jt = [jops._tile(np.asarray(x))[0] for x in xs]
    jc = jfe.fused_candidates(
        *jt, omega=OMEGA, mu=MU, q=Q, y=y, m=m, interpret=True
    )
    jsel = jfe.select_from_candidates(*jc, k)
    tt = [tops._tile(torch.from_numpy(x)[None])[0] for x in xs]
    tc = tfe.fused_candidates(*tt, omega=OMEGA, mu=MU, q=Q, y=y, m=m)
    tsel = tfe.select_from_candidates(*tc, k)
    return (jc, jsel), (tc, tsel)


def _assert_same(j, t):
    (jcs, jcv, jci), (jv, ji, jok) = j
    (tcs, tcv, tci), (tv, ti, tok) = t
    np.testing.assert_array_equal(tci[0].numpy(), np.asarray(jci))
    np.testing.assert_allclose(tcs[0].numpy(), np.asarray(jcs), rtol=RTOL)
    np.testing.assert_allclose(tcv[0].numpy(), np.asarray(jcv), rtol=RTOL)
    np.testing.assert_array_equal(ti[0].numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv[0].numpy(), np.asarray(jv), rtol=RTOL)
    assert bool(tok[0]) == bool(jok)


@pytest.mark.parametrize("m", [8, 16])
@pytest.mark.parametrize("y", [1.0, 2.0])
@pytest.mark.parametrize("n", [100, 8192, 3 * 8192 + 17])
def test_fused_candidates_match_jax(n, y, m):
    k = -(-n // 8192) * m // 2
    j, t = _both(_inputs(n, seed=n + m), k, m, y)
    _assert_same(j, t)


def test_certificate_fails_on_concentrated_tile():
    """More than m winners in one tile: the budget cannot prove the
    selection exact, and both stacks say so."""
    n, m, k = 3 * 8192, 8, 20
    xs = list(_inputs(n, seed=7))
    xs[0][:100] *= 100.0  # tile 0 holds the mass
    j, t = _both(xs, k, m, 1.0)
    _assert_same(j, t)
    assert not bool(t[1][2][0])


def test_certificate_fails_on_zero_scores():
    """Fewer positive scores than k: tau is 0, zero scores are never
    selected, and the certificate fails (padding stays off the wire)."""
    n, m, k = 2 * 8192, 16, 12
    xs = list(_inputs(n, seed=3))
    xs[0][:] = 0.0
    xs[0][[5, 9000, 11]] = [1.0, -2.0, 3.0]
    j, t = _both(xs, k, m, 1.0)
    _assert_same(j, t)
    assert not bool(t[1][2][0])
    assert int((t[1][0][0] != 0).sum()) == 3


@pytest.mark.parametrize("nan", ["one", "tile"])
def test_nan_scores_match_jax(nan):
    """A tile holding a NaN score emits (NaN, 0, INT32_MAX) in every round,
    as the TPU kernel does, whether one score or all of them are NaN; the
    certificate fails, so the dense path answers."""
    n, m, k = 3 * 8192, 8, 12
    xs = list(_inputs(n, seed=11))
    if nan == "one":
        xs[0][8192 + 5] = np.nan
    else:
        xs[0][8192:16384] = np.nan
    j, t = _both(xs, k, m, 1.0)
    _assert_same(j, t)
    tcs, tcv, tci = t[0]
    assert torch.isnan(tcs[0, 1]).all() and (tcv[0, 1] == 0).all()
    assert (tci[0, 1] == torch.iinfo(torch.int32).max).all()
    assert not bool(t[1][2][0])


def test_fused_select_encode_batches_workers():
    """The [W, L] wrapper gives each worker the payload it gets alone."""
    n, k, m = 2 * 8192 + 5, 40, 16
    rows = [_inputs(n, seed=s) for s in (1, 2)]
    stacked = [torch.from_numpy(np.stack(c)) for c in zip(*rows, strict=True)]
    v, i, ok = tops.fused_select_encode(
        *stacked, k=k, omega=OMEGA, mu=MU, q=Q, y=1.0, m=m
    )
    for w, xs in enumerate(rows):
        vw, iw, okw = tops.fused_select_encode(
            *[torch.from_numpy(x)[None] for x in xs],
            k=k, omega=OMEGA, mu=MU, q=Q, y=1.0, m=m,
        )
        assert torch.equal(v[w], vw[0]) and torch.equal(i[w], iw[0])
        assert bool(ok[w]) == bool(okw[0])


def test_wrapper_rejects_bad_layout():
    x = torch.zeros(1, 12, 1024)
    with pytest.raises(ValueError, match="rows"):
        tfe.fused_candidates(x, x, x, x, omega=OMEGA, mu=MU, m=8)

