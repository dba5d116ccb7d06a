"""The port's sort-free selection kernels against the JAX package's.

``count_above``, ``global_max`` and ``block_topk_candidates`` and the two
public selections built on them (``ops.threshold_topk_mask``,
``ops.hierarchical_topk``), on the same numpy-seeded inputs. The JAX side
runs its Pallas kernels in interpret mode; the port's wrappers compute
their plain versions on the CPU. Every comparison is exact: counts,
maxima, masks, candidate values and indices (NaN equal to NaN). Inputs stay
at one or two 8192-element tiles to keep interpret mode fast.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import block_topk as jbt
from repro.kernels import ops as jops
from repro.kernels import threshold_topk as jtt
from repro_torch.core import selectors as tsel
from repro_torch.kernels import block_topk as bt
from repro_torch.kernels import ops
from repro_torch.kernels import threshold_topk as tt

TILE = 8192


def _score(n, seed, case=None):
    """``|3 N(0, 1)|`` of length n; ``case`` "ties" rounds it to quarters
    (equal scores inside and across tiles), "nan" puts a NaN at n // 2."""
    s = np.abs(3.0 * np.random.default_rng(seed).standard_normal(n))
    if case == "ties":
        s = np.rint(4.0 * s) / 4.0
    elif case == "nan":
        s[n // 2] = np.nan
    return s.astype(np.float32)


def _tiles(s):
    """[rows, 1024] numpy tiles -> the port's [1, rows, 1024]."""
    return torch.from_numpy(s.reshape(1, -1, 1024).copy())


def _jax_mask(score, k, **kw):
    return np.asarray(jops.threshold_topk_mask(jnp.asarray(score), k,
                                               interpret=True, **kw))


@pytest.mark.parametrize("case", [None, "ties", "nan"])
@pytest.mark.parametrize("tau", [0.0, 1.7, 3.0, np.nan])
def test_count_above_and_global_max_match_jax(tau, case):
    s = _score(2 * TILE, 3, case).reshape(-1, 1024)
    tiles = _tiles(s)
    got = tt.count_above(tiles, torch.tensor([tau], dtype=torch.float32))
    want = jtt.count_above(jnp.asarray(s), jnp.float32(tau), interpret=True)
    assert got.dtype == torch.int32 and got.shape == (1,)
    assert int(got[0]) == int(want)
    gm = tt.global_max(tiles)
    np.testing.assert_array_equal(
        gm.numpy(), [np.asarray(jtt.global_max(jnp.asarray(s), interpret=True))]
    )
    assert bool(torch.isnan(gm[0])) == (case == "nan")


def test_count_above_rejects_a_mismatched_tau():
    tiles = torch.zeros(2, 8, 1024)
    with pytest.raises(ValueError, match="tau must be"):
        tt.count_above(tiles, torch.zeros(1))


@pytest.mark.parametrize("n,k,dtype,case", [
    (TILE + 17, 50, "float32", None),  # ragged: padding in the last tile
    (5000, 40, "bfloat16", None),
    (2 * TILE, 37, "float32", "ties"),
    (TILE + 17, 50, "float32", "nan"),
    (3000, 10, "float32", "zero"),
    (100, 100, "float32", None),  # k == L
    (100, 150, "float32", None),  # L < k <= padded length
    (100, 9000, "float32", None),  # k > padded length
])
def test_threshold_topk_mask_matches_jax(n, k, dtype, case):
    s = np.zeros(n, np.float32) if case == "zero" else _score(n, n + k, case)
    score = torch.from_numpy(s).to(getattr(torch, dtype))
    got = ops.threshold_topk_mask(score, k)
    want = _jax_mask(jnp.asarray(s).astype(dtype), k)
    assert got.shape == (n,) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    live = score.float() > 0
    if case == "zero":
        assert got.sum() == 0
    elif k >= n:
        # no bracket reaches k: tau stays 0 and every positive score is in
        # the mask, as core.selectors' k >= L contract gives
        assert torch.equal(got, live.float())
        assert torch.equal(tsel.threshold_topk_mask(score.float(), k), live.float())
    elif case != "nan":
        # for k < L the kernel-driven bisection is the selector's, bit for bit
        assert torch.equal(got, tsel.threshold_topk_mask(score.float(), k))
        assert got.sum() >= k


def test_threshold_topk_mask_kernel_module_matches_jax():
    """The tile-level driver and its plain version against
    ``repro.kernels.threshold_topk`` and ``ref``, two workers at once."""
    from repro.kernels import ref as jref

    s = np.stack([_score(2 * TILE, 7), _score(2 * TILE, 8, "ties")])
    tiles = torch.from_numpy(s.reshape(2, -1, 1024))
    got = tt.threshold_topk_mask(tiles, 300, n_iters=20)
    assert torch.equal(got, tt.threshold_topk_mask_ref(tiles, 300, n_iters=20))
    for w in range(2):
        js = jnp.asarray(s[w].reshape(-1, 1024))
        want = jtt.threshold_topk_mask(js, 300, n_iters=20, interpret=True)
        np.testing.assert_array_equal(got[w].numpy(), np.asarray(want))
        np.testing.assert_array_equal(
            got[w].numpy(), np.asarray(jref.threshold_topk_mask_ref(js, 300, 20))
        )


@pytest.mark.parametrize("m", [1, 8, 16])
@pytest.mark.parametrize("case", ["ties", "nan", "exhausted"])
def test_block_topk_candidates_match_jax(m, case):
    if case == "exhausted":
        # tile 1 holds 3 scores above -inf: later rounds find only -inf
        s = np.full(2 * TILE, -np.inf, np.float32)
        s[:TILE] = _score(TILE, 4)
        s[[TILE + 9, TILE + 700, 2 * TILE - 1]] = [2.0, 5.0, 2.0]
    else:
        s = _score(2 * TILE, 5, case)
    vals, idx = bt.block_topk_candidates(_tiles(s), m=m)
    jv, ji = jbt.block_topk_candidates(
        jnp.asarray(s.reshape(-1, 1024)), m=m, interpret=True
    )
    assert vals.shape == (1, 2, m) and idx.dtype == torch.int32
    np.testing.assert_array_equal(vals[0].numpy(), np.asarray(jv))
    np.testing.assert_array_equal(idx[0].numpy(), np.asarray(ji))
    if case == "nan":
        assert (idx[0, 1] == bt.INT32_MAX).all() and torch.isnan(vals[0, 1]).all()


def _bits(x):
    return np.asarray(x).view(np.uint32)


@pytest.mark.parametrize("m", [4, 8])
@pytest.mark.parametrize("swap", [False, True])
def test_block_topk_signed_zeros_match_jax_bits(swap, m):
    """The masked max emits +0.0 while a +0.0 at or after the picked zero
    is still in the tile, whatever the sign of the zero it picks: one tile
    at -1.0 with zeros at 3, 5 and 7 and 2.0 at 100, compared in f32
    bits (a value comparison cannot tell -0.0 from +0.0)."""
    s = np.full(TILE, -1.0, np.float32)
    inner, outer = (np.float32(0.0), np.float32(-0.0))
    if swap:
        inner, outer = outer, inner
    s[[3, 7]] = outer
    s[5] = inner
    s[100] = 2.0
    vals, idx = bt.block_topk_candidates(_tiles(s), m=m)
    jv, ji = jbt.block_topk_candidates(jnp.asarray(s.reshape(-1, 1024)), m=m,
                                       interpret=True)
    np.testing.assert_array_equal(_bits(vals[0]), _bits(jv))
    np.testing.assert_array_equal(idx[0].numpy(), np.asarray(ji))
    assert idx[0, 0, :4].tolist() == [100, 3, 5, 7]


@pytest.mark.parametrize("m", [1, 8, 16])
@pytest.mark.parametrize("n,k,case", [
    (2 * TILE, 2, "ties"),
    (TILE + 300, 7, None),  # ragged
    (2 * TILE, 5, "nan"),
])
def test_hierarchical_topk_matches_jax(n, k, case, m):
    k = min(k, 2 * m)  # two tiles hold 2m candidates
    s = _score(n, n + m, case)
    vals, idx = ops.hierarchical_topk(torch.from_numpy(s), k, m=m)
    jv, ji = jops.hierarchical_topk(jnp.asarray(s), k, m=m, interpret=True)
    assert vals.shape == (k,) and idx.dtype == torch.int32
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))


def test_hierarchical_topk_bf16_matches_jax():
    s = _score(5000, 9)
    vals, idx = ops.hierarchical_topk(torch.from_numpy(s).bfloat16(), 6)
    jv, ji = jops.hierarchical_topk(
        jnp.asarray(s).astype(jnp.bfloat16), 6, interpret=True
    )
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))


def test_hierarchical_topk_refuses_k_above_the_candidates():
    with pytest.raises(ValueError, match="exceeds the 2x8 candidates"):
        ops.hierarchical_topk(torch.ones(2 * TILE), 17, m=8)


def test_cpu_tensors_take_the_plain_versions():
    tiles = _tiles(_score(TILE, 1))
    before = (tt.count_above.launches, tt.global_max.launches,
              bt.block_topk_candidates.launches)
    ops.threshold_topk_mask(tiles.reshape(-1), 10)
    ops.hierarchical_topk(tiles.reshape(-1), 10, m=16)
    assert (tt.count_above.launches, tt.global_max.launches,
            bt.block_topk_candidates.launches) == before


def test_other_devices_raise():
    x = torch.zeros(1, 8, 1024, device="meta")
    with pytest.raises(ValueError, match="no global_max kernel"):
        tt.global_max(x)
    with pytest.raises(ValueError, match="no count_above kernel"):
        tt.count_above(x, torch.zeros(1, device="meta"))
    with pytest.raises(ValueError, match="no block_topk_candidates kernel"):
        bt.block_topk_candidates(x)
