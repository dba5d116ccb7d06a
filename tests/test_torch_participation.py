"""The port's participation schedules and the collectives' partial rounds
against the JAX package's ``repro.comm.participation``.

* ``round_robin`` and ``stale`` are integer functions of the round: their
  masks equal JAX's exactly for N in {2, 5, 8, 20} over rounds 0–40, and
  so do ``participating_weights`` in f32 bits up to N = 8 (at N = 20
  XLA:CPU sums the masked weights in another order: rtol 1e-6);
* ``expected_participants``, ``effective_omega``, ``validate`` and
  ``parse_participation`` give JAX's answers, errors included;
* ``renormalize_weights`` equals JAX's on numpy weights and masks;
* ``bernoulli`` and ``sampled`` draw from a ``torch.Generator`` seeded
  from ``(seed, round)``, where JAX draws with ``jax.random``: their
  streams differ, so the port's draws are held to the JAX package's
  invariants (worker ``round % N`` always kept; S sorted distinct
  indices; the same draw for the same round; the mask is the cohort's);
* ``participation=`` on the ``reference`` and ``reference_coord`` forms of
  all three collectives against JAX's on shared payloads and masks:
  ``sparse_allgather`` and ``hierarchical`` in f32 bits, ``dense_allreduce``
  to rtol 1e-6 (XLA:CPU's einsum sums the workers in another order);
* a full schedule and a zero-rate ``bernoulli`` are the no-participation
  path bit for bit.

The shard forms are held in ``tests/test_torch_shard.py`` and the
per-rank round in ``tests/test_torch_ranks.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import collectives as jcoll
from repro.comm import participation as jp
from repro.comm.codec import get_codec as jax_codec
from repro_torch.comm import collectives as tcoll
from repro_torch.comm import participation as tp
from repro_torch.comm.codec import get_codec
import _torch_cores  # noqa: F401  (this worker's share of the cores)

NS = (2, 5, 8, 20)
ROUNDS = range(41)


def _pair(kind, **kw):
    return tp.Participation(kind, **kw), jp.Participation(kind, **kw)


def _straggler_schedules(n):
    """round_robin and stale schedules realizable over n workers."""
    out = []
    for ns in sorted({1, 2, 3, n - 1} & set(range(1, n))):
        out.append(("round_robin", dict(n_stragglers=ns)))
        out.append(("stale", dict(n_stragglers=ns, staleness=2, discount=0.5)))
    return out


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


@pytest.mark.parametrize("n", NS)
def test_straggler_masks_match_jax_exactly(n):
    for kind, kw in _straggler_schedules(n):
        tpart, jpart = _pair(kind, **kw)
        for r in ROUNDS:
            got = tpart.round_mask(r, n, device="cpu")
            assert got.dtype == torch.float32 and got.shape == (n,)
            np.testing.assert_array_equal(
                _bits(got), _bits(jpart.round_mask(r, n)), err_msg=f"{kind} {kw} r={r}")


@pytest.mark.parametrize("n", NS)
def test_straggler_weights_match_jax_bits(n):
    """``participating_weights`` of uniform and of numpy weights."""
    rng = np.random.default_rng(n)
    bases = [np.full(n, 1.0 / n, np.float32),
             rng.uniform(0.1, 1.0, n).astype(np.float32)]
    for kind, kw in _straggler_schedules(n):
        tpart, jpart = _pair(kind, **kw)
        for base in bases:
            for r in (0, 1, 7, 40):
                got = tpart.participating_weights(torch.from_numpy(base), r)
                want = jpart.participating_weights(jnp.asarray(base), r)
                if n <= 8:
                    np.testing.assert_array_equal(_bits(got), _bits(want))
                else:
                    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                               rtol=1e-6)


def test_far_round_wraps_as_jax_does():
    """``round * n_stragglers`` wraps in int32 in both stacks."""
    tpart, jpart = _pair("round_robin", n_stragglers=3)
    for r in (2**31 // 3 - 1, 2**31 // 3 + 5, 2**31 - 1):
        np.testing.assert_array_equal(
            tpart.round_mask(r, 7, device="cpu").numpy(), np.asarray(jpart.round_mask(r, 7)))


SCHEDULES = [
    ("full", {}),
    ("bernoulli", dict(drop_rate=0.0)),
    ("bernoulli", dict(drop_rate=0.25, seed=3)),
    ("bernoulli", dict(drop_rate=0.9)),
    ("round_robin", dict(n_stragglers=1)),
    ("round_robin", dict(n_stragglers=3)),
    ("stale", dict(n_stragglers=2, staleness=3, discount=0.5)),
    ("stale", dict(n_stragglers=1, discount=0.0)),
    ("sampled", dict(n_sampled=1)),
    ("sampled", dict(n_sampled=4, seed=9)),
]


@pytest.mark.parametrize("kind,kw", SCHEDULES)
def test_scalar_queries_match_jax(kind, kw):
    tpart, jpart = _pair(kind, **kw)
    assert (tpart.is_full, tpart.delays_payloads) == (jpart.is_full,
                                                       jpart.delays_payloads)
    for n in (1, 2, 4, 5, 8, 20, 2000):
        def outcome(p):
            try:
                p.validate(n)
            except ValueError as e:
                return str(e)
            return (p.expected_participants(n), p.effective_omega(n))
        assert outcome(tpart) == outcome(jpart), n


@pytest.mark.parametrize("kw", [
    dict(kind="bogus"), dict(kind="bernoulli", drop_rate=1.0),
    dict(kind="bernoulli", drop_rate=-0.1), dict(kind="round_robin", n_stragglers=0),
    dict(kind="stale", staleness=0), dict(kind="stale", discount=-1.0),
    dict(kind="sampled", n_sampled=0),
])
def test_bad_schedules_raise_as_jax(kw):
    with pytest.raises(ValueError) as want:
        jp.Participation(**kw)
    with pytest.raises(ValueError) as got:
        tp.Participation(**kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("spec", [
    None, "", "full", "bernoulli:0.25", "bernoulli:0.5,7", "round_robin:2",
    "stale:1", "stale:1,2", "stale:1,2,0.5", "sampled:32", "sampled:32,7",
    " round_robin : 3 ", "full:1", "bernoulli", "bernoulli:0.1,2,3",
    "round_robin:1,2", "stale:", "sampled:a", "bogus:1", "bernoulli:1.5",
])
def test_parse_participation_matches_jax(spec):
    def outcome(mod):
        try:
            return dataclasses.asdict(mod.parse_participation(spec))
        except ValueError as e:
            return str(e)
    assert outcome(tp) == outcome(jp)


def test_renormalize_weights_matches_jax():
    rng = np.random.default_rng(0)
    for n in (2, 5, 8, 20):
        for _ in range(5):
            w = rng.uniform(0.0, 1.0, n).astype(np.float32)
            m = (rng.uniform(size=n) < 0.6).astype(np.float32)
            got = tp.renormalize_weights(torch.from_numpy(w), torch.from_numpy(m))
            want = jp.renormalize_weights(jnp.asarray(w), jnp.asarray(m))
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
            assert float(got.sum()) == pytest.approx(1.0, rel=1e-6) or m.sum() == 0
    zero = tp.renormalize_weights(torch.full((3,), 0.5), torch.zeros(3))
    assert torch.equal(zero, torch.zeros(3))


def test_bernoulli_draws_keep_the_jax_invariants():
    p = tp.Participation("bernoulli", drop_rate=0.5, seed=7)
    n, drops = 8, []
    for r in range(400):
        m = p.round_mask(r, n, device="cpu")
        assert set(m.unique().tolist()) <= {0.0, 1.0}
        assert m[r % n] == 1.0  # the rotating liveness worker
        assert torch.equal(m, p.round_mask(r, n, device="cpu"))  # common knowledge
        drops.append(float((1 - m).sum()))
    # (N - 1) * drop_rate workers drop on average
    assert np.mean(drops) == pytest.approx(7 * 0.5, abs=0.3)
    other = tp.Participation("bernoulli", drop_rate=0.5, seed=8)
    assert any(not torch.equal(p.round_mask(r, n, device="cpu"),
                               other.round_mask(r, n, device="cpu"))
               for r in range(10))
    assert p.round_mask(3, n, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("n,s", [(6, 1), (6, 2), (32, 8), (32, 32), (2000, 32)])
def test_sampled_cohort_keeps_the_jax_invariants(n, s):
    p = tp.Participation("sampled", n_sampled=s, seed=1)
    seen = set()
    for r in range(30):
        c = p.round_participants(r, n, device="cpu")
        assert c.shape == (s,) and c.dtype == torch.int64
        assert bool((c[1:] > c[:-1]).all()) and 0 <= int(c[0]) and int(c[-1]) < n
        assert torch.equal(c, p.round_participants(r, n, device="cpu"))
        mask = p.round_mask(r, n, device="cpu")
        assert torch.equal(torch.nonzero(mask)[:, 0], c)
        seen.update(c.tolist())
    if s < n:
        assert len(seen) > s  # the cohort moves from round to round


def test_worker_index_is_the_rank():
    from repro_torch.launch.mesh import DpGroups

    assert tp.worker_index(DpGroups(("pod", "data"), (2, 4), (None, None), 6)) == 6


L, K = 300, 12


def _payload_inputs(n, seed):
    rng = np.random.default_rng(seed)
    vals = rng.standard_normal((n, K)).astype(np.float32)
    idx = np.stack([rng.choice(L, K, replace=False) for _ in range(n)]).astype(np.int32)
    vals[:, -1], idx[:, -1] = 0.0, 0
    return vals, idx


COLL_CASES = [(c, codec, n, r)
              for c in ("sparse_allgather", "hierarchical", "dense_allreduce")
              for codec in ("coo_fp32", "coo_q8")
              for n, r in ((4, 1), (5, 3))]


@pytest.mark.parametrize("coll,codec,n,r", COLL_CASES)
@pytest.mark.parametrize("weighting", ["worker", "coordinate"])
def test_reference_forms_with_participation_match_jax(coll, codec, n, r,
                                                      weighting):
    """A round_robin round's mask (and a bernoulli-like mask) on the
    reference forms, against JAX's on the same payloads."""
    vals, idx = _payload_inputs(n, 10 * n + r)
    masks = [
        tp.Participation("round_robin", n_stragglers=2).round_mask(
            r, n, device="cpu").numpy(),
        (np.arange(n) % 2 == 0).astype(np.float32),
    ]
    tcd, jcd = get_codec(codec), jax_codec(codec)
    tpay = tcd.encode(torch.from_numpy(vals), torch.from_numpy(idx).long(), L)
    # jitted, as the JAX runtimes encode (coo_q8's scale is amax * fl(1/127))
    jpay = jax.jit(lambda v, i: jcd.encode(v, i, L))
    jstack = {k: jnp.stack([jpay(jnp.asarray(vals[w]), jnp.asarray(idx[w]))[k]
                            for w in range(n)]) for k in tpay}
    tc, jc = tcoll.get_collective(coll), jcoll.get_collective(coll)
    for mask in masks:
        for weights in (1.0 / n, np.full(n, 1.0 / n, np.float32)):
            tw = weights if np.isscalar(weights) else torch.from_numpy(weights)
            jw = weights if np.isscalar(weights) else jnp.asarray(weights)
            if weighting == "coordinate":
                got = tc.reference_coord(tcd, tpay, tw, L, participation=torch.from_numpy(mask))
                want = jc.reference_coord(jcd, jstack, jw, L, participation=jnp.asarray(mask))
            else:
                got = (tc.reference(tcd, tpay, tw, L, participation=torch.from_numpy(mask)),)
                want = (jc.reference(jcd, jstack, jw, L, participation=jnp.asarray(mask)),)
            for g, w in zip(got, want, strict=True):
                if coll == "dense_allreduce":
                    np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                               atol=1e-7)
                else:
                    np.testing.assert_array_equal(_bits(g), _bits(w))
            # the dropped workers' coordinates carry no weight
            dropped = np.unique(idx[mask == 0])
            only_dropped = np.setdiff1d(dropped, idx[mask > 0])
            assert not np.any(got[0].numpy()[only_dropped])


@pytest.mark.parametrize("coll", ["sparse_allgather", "hierarchical", "dense_allreduce"])
def test_full_schedule_is_the_full_round_bit_for_bit(coll):
    """An all-ones mask renormalizes 1/N weights to themselves and a full
    schedule is skipped by its callers: both give the full round."""
    n = 4
    vals, idx = _payload_inputs(n, 3)
    cd = get_codec("coo_fp32")
    pay = cd.encode(torch.from_numpy(vals), torch.from_numpy(idx).long(), L)
    c = tcoll.get_collective(coll)
    full = c.reference(cd, pay, 1.0 / n, L)
    ones = tp.Participation("full").round_mask(5, n, device="cpu")
    assert torch.equal(ones, torch.ones(n))
    assert torch.equal(
        c.reference(cd, pay, torch.full((n,), 1.0 / n), L, participation=ones), full)
    w = torch.full((n,), 0.25)
    assert tp.Participation("bernoulli", drop_rate=0.0).participating_weights(w, 3) is w
