"""The port's sparsifiers, selectors and payload aggregation against the
JAX package's.

For each of the six kinds, the JAX package reaches a state by its own
``init`` and a few ``step``s (vmapped over the workers); the state is
converted (``repro_torch.convert.dense_state_from_jax``) and both stacks
take one more step on the same gradient. Masks are exact (the random
scores are well separated); floats agree to rtol 1e-5, because XLA:CPU's
and PyTorch's tanh differ in the last ulp. The ``on_wire_residual`` and
``on_dropped`` hooks are held against the JAX hooks the same way.

The selectors run along the last axis of a ``[N, L]`` score and are held
row by row against ``repro.core.selectors``, ties included. Two known
differences at the boundary are pinned here (ROADMAP §3).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import collectives as jcoll
from repro.core import selectors as jsel
from repro.core import sparsify as jsp
from repro_torch.comm.codec import get_codec
from repro_torch.comm.collectives import COLLECTIVES, scatter_add_payloads
from repro_torch.convert import dense_state_from_jax
from repro_torch.core import selectors as tsel
from repro_torch.core import sparsify as tsp

RTOL = 1e-5
N, L = 3, 96
KINDS = ["none", "topk", "regtopk", "hard_threshold", "coordtopk", "dgc"]


def _cfg(kind, y=1.0):
    return tsp.SparsifierConfig(
        kind=kind, sparsity=0.1, mu=2.0, y=y, omega=1.0 / N, threshold=0.8,
        momentum=0.9,
    )


def _jax(cfg):
    return jsp.make_sparsifier(jsp.SparsifierConfig(**dataclasses.asdict(cfg)))


def _jax_step(sp, st, g, gprev):
    return jax.vmap(lambda s, x: sp.step(s, x, gprev))(st, g)


def _jax_state(kind, rng, rounds=3, y=1.0):
    """The JAX sparsifier's own state after ``rounds`` steps of random
    gradients, each round's ``g_agg_prev`` the mean of the workers' ghat."""
    sp = _jax(_cfg(kind, y))
    one = sp.init(L)
    st = jax.tree.map(lambda x: jnp.broadcast_to(x, (N,) + x.shape), one)
    gprev = jnp.zeros(L)
    for _ in range(rounds):
        g = jnp.asarray(rng.standard_normal((N, L)).astype(np.float32))
        ghat, _, st = _jax_step(sp, st, g, gprev)
        gprev = ghat.mean(axis=0)
    return sp, st, gprev


def _assert_state(tst, jst, exact_slots=("s_prev", "t")):
    for name in ("eps", "a_prev", "s_prev", "t"):
        got = getattr(tst, name).numpy()
        want = np.asarray(getattr(jst, name))
        if name in exact_slots:
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("kind,y", [(k, 1.0) for k in KINDS] + [("regtopk", 2.0)])
def test_one_step_from_a_jax_state(kind, y):
    rng = np.random.default_rng(KINDS.index(kind) + int(y))
    jsp_, jst, gprev = _jax_state(kind, rng, y=y)
    g = rng.standard_normal((N, L)).astype(np.float32)
    jghat, jmask, jnew = _jax_step(jsp_, jst, jnp.asarray(g), gprev)

    tsp_ = tsp.make_sparsifier(_cfg(kind, y))
    tst = dense_state_from_jax(jax.tree.map(np.asarray, jst), device="cpu")
    ghat, mask, new = tsp_.step(
        tst, torch.from_numpy(g), torch.tensor(np.asarray(gprev))
    )
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    np.testing.assert_allclose(ghat.numpy(), np.asarray(jghat), rtol=RTOL, atol=1e-6)
    _assert_state(new, jnew)
    if kind in ("topk", "regtopk", "dgc", "coordtopk"):
        assert (mask.sum(dim=1) == tsel.sparsity_to_k(L, 0.1)).all()


@pytest.mark.parametrize("kind", KINDS)
def test_hooks_match_jax(kind):
    rng = np.random.default_rng(100 + KINDS.index(kind))
    jsp_, jold, gprev = _jax_state(kind, rng, rounds=2)
    g = jnp.asarray(rng.standard_normal((N, L)).astype(np.float32))
    jghat, _, jnew = _jax_step(jsp_, jold, g, gprev)
    delta = jnp.asarray(1e-3 * rng.standard_normal((N, L)).astype(np.float32))

    tsp_ = tsp.make_sparsifier(_cfg(kind))
    conv = lambda s: dense_state_from_jax(jax.tree.map(np.asarray, s), "cpu")  # noqa: E731
    told, tnew = conv(jold), conv(jnew)
    tghat = torch.tensor(np.asarray(jghat))

    want = jax.vmap(jsp_.on_wire_residual)(jnew, delta)
    got = tsp_.on_wire_residual(tnew, torch.tensor(np.asarray(delta)))
    _assert_state(got, want)

    want = jax.vmap(jsp_.on_dropped)(jold, jnew, jghat)
    got = tsp_.on_dropped(told, tnew, tghat)
    _assert_state(got, want)


def test_omega_prev_is_not_ported():
    sp = tsp.make_sparsifier(_cfg("regtopk"))
    st = sp.init(N, L, device="cpu")
    z = torch.zeros(N, L)
    with pytest.raises(ValueError, match="queue 1 item 4"):
        sp.step(st, z, z[0], omega_prev=torch.ones(L))


def test_unknown_kind_raises():
    with pytest.raises(ValueError, match="unknown sparsifier kind"):
        tsp.make_sparsifier(_cfg("randk"))


# ---------------------------------------------------------------------------
# selectors, row by row against repro.core.selectors
# ---------------------------------------------------------------------------
def _scores(seed, ties):
    rng = np.random.default_rng(seed)
    if ties:  # small integers: many exact ties, and zeros
        return rng.integers(0, 4, size=(N, 40)).astype(np.float32)
    return np.abs(rng.standard_normal((N, 40))).astype(np.float32)


def _rows(fn, *arrays):
    """``fn`` (a JAX selector of 1-D rows) applied row by row, stacked."""
    outs = [fn(*(jnp.asarray(a[n]) for a in arrays)) for n in range(len(arrays[0]))]
    if isinstance(outs[0], tuple):
        return tuple(np.stack([np.asarray(o[i]) for o in outs]) for i in range(2))
    return np.stack([np.asarray(o) for o in outs])


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("k", [1, 7, 39])
def test_selectors_match_jax(k, ties):
    score = _scores(k, ties)
    values = np.random.default_rng(k).standard_normal((N, 40)).astype(np.float32)
    ts, tv = torch.from_numpy(score), torch.from_numpy(values)

    want = _rows(lambda s: jsel.exact_topk_mask(s, k), score)
    np.testing.assert_array_equal(tsel.exact_topk_mask(ts, k).numpy(), want)
    want = _rows(lambda s: jsel.threshold_topk_mask(s, k), score)
    np.testing.assert_array_equal(tsel.threshold_topk_mask(ts, k).numpy(), want)

    jv, ji = _rows(lambda s, v: jsel.fixed_k_payload(s, v, k), score, values)
    v, i = tsel.fixed_k_payload(ts, tv, k)
    np.testing.assert_array_equal(i.numpy(), ji)
    np.testing.assert_array_equal(v.numpy(), jv)

    mask = (score > 1.0).astype(np.float32)  # fewer than k entries in some rows
    jv, ji = _rows(lambda m, v: jsel.mask_to_payload(m, v, k), mask, values)
    v, i = tsel.mask_to_payload(torch.from_numpy(mask), tv, k)
    np.testing.assert_array_equal(i.numpy(), ji)
    np.testing.assert_array_equal(v.numpy(), jv)

    assert tsel.get_selector("threshold") is tsel.threshold_topk_mask
    with pytest.raises(ValueError, match="unknown selector"):
        tsel.get_selector("radix")


def test_threshold_mask_never_selects_zero_scores_at_k_ge_L():
    """ROADMAP §3: the JAX ``threshold_topk_mask`` returns all ones when
    k >= L, zero scores included; the port keeps the contract that a zero
    score is never selected."""
    score = np.array([0.0, 0.0, 0.5, 0.0], np.float32)
    jmask = np.asarray(jsel.threshold_topk_mask(jnp.asarray(score), 4))
    np.testing.assert_array_equal(jmask, [1.0, 1.0, 1.0, 1.0])
    tmask = tsel.threshold_topk_mask(torch.from_numpy(score), 4)
    assert tmask.tolist() == [0.0, 0.0, 1.0, 0.0]
    assert tsel.threshold_topk_mask(torch.zeros(4), 4).tolist() == [0.0] * 4


def test_subnormal_score_is_positive_in_the_port():
    """ROADMAP §3: a subnormal score. XLA:CPU flushes it to zero, so the
    JAX selectors select nothing; PyTorch keeps IEEE subnormals on the
    CPU and on the card, so the port selects it as the positive score it
    is."""
    score = np.array([0.0, 1.4e-45], np.float32)
    assert score[1] > 0
    jmask = np.asarray(jsel.exact_topk_mask(jnp.asarray(score), 1))
    np.testing.assert_array_equal(jmask, [0.0, 0.0])
    for select in (tsel.exact_topk_mask, tsel.threshold_topk_mask):
        assert select(torch.from_numpy(score), 1).tolist() == [0.0, 1.0]


def test_padded_payload_aggregates_bit_equal_to_jax():
    """``mask_to_payload`` pads a short mask with ``(±0.0, index 0)``
    slots, so index 0 repeats within a payload. The one-card scatter-add
    still equals the JAX package's flat scatter-add bit for bit, signed
    zeros included."""
    rng = np.random.default_rng(5)
    n, length, k = 6, 50, 12
    values = rng.standard_normal((n, length)).astype(np.float32)
    values[2, 0] = -0.0
    mask = (rng.random((n, length)) < 0.15).astype(np.float32)
    mask[1, :] = 0.0  # an all-padding payload
    mask[3, 0] = 1.0  # a real entry at index 0 beside the padding
    weights = np.full((n,), 1.0 / n, np.float32)
    jv, ji = _rows(lambda m, v: jsel.mask_to_payload(m, v, k), mask, values)
    assert (ji == 0).sum() > n  # padding present
    want = np.asarray(jcoll.scatter_add_payloads(
        jnp.asarray(jv), jnp.asarray(ji), jnp.asarray(weights), length
    ))
    tv, ti = tsel.mask_to_payload(
        torch.from_numpy(mask), torch.from_numpy(values), k
    )
    np.testing.assert_array_equal(ti.numpy(), ji)
    w = torch.from_numpy(weights)
    got = scatter_add_payloads(tv, ti, w, length)
    coo = get_codec("coo_fp32")
    via = COLLECTIVES["sparse_allgather"].reference(
        coo, coo.encode(tv, ti, length), w, length
    )
    for agg in (got, via):
        np.testing.assert_array_equal(agg.numpy().view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("scalar_weight", [False, True])
def test_dense_allreduce_reference_matches_jax(scalar_weight):
    """The dense reduction of decoded payloads, against the JAX
    ``DenseAllreduce.reference`` on the same payloads (rtol 1e-6: the two
    stacks' weighted sums may add in another order)."""
    from repro.comm import codec as jcodec

    rng = np.random.default_rng(8)
    n, length, k = 5, 40, 6
    vals = rng.standard_normal((n, k)).astype(np.float32)
    idx = np.stack([rng.permutation(length)[:k] for _ in range(n)]).astype(np.int32)
    weights = 0.2 if scalar_weight else np.full((n,), 0.2, np.float32)
    jc = jcodec.get_codec("coo_fp32")
    jpay = jax.vmap(lambda v, i: jc.encode(v, i, length))(jnp.asarray(vals), jnp.asarray(idx))
    want = np.asarray(jcoll.COLLECTIVES["dense_allreduce"].reference(
        jc, jpay, weights if scalar_weight else jnp.asarray(weights), length
    ))
    coo = get_codec("coo_fp32")
    w = weights if scalar_weight else torch.from_numpy(weights)
    got = COLLECTIVES["dense_allreduce"].reference(
        coo, coo.encode(torch.from_numpy(vals), torch.from_numpy(idx).long(), length),
        w, length,
    )
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="item 6"):
        COLLECTIVES["dense_allreduce"].reference(
            coo, coo.encode(torch.from_numpy(vals), torch.from_numpy(idx).long(), length),
            w, length, participation=torch.ones(n),
        )
