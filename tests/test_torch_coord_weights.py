"""Coordinate weighting and the fastpath's "auto" pricing in the port
against the JAX package.

* ``reference_coord`` of the three collectives, for every codec, on the
  same payload stacks. ``sparse_allgather`` and ``hierarchical``: ``(agg,
  den)`` equal in f32 bits (the port sums one worker at a time in worker
  order, the JAX package's flat scatter-add order); ``reference`` too.
  ``dense_allreduce`` sums the dense vectors with an einsum whose order
  XLA:CPU picks by the worker count (in worker order at N = 8, not at N
  = 5 or 20) and PyTorch by its own blocking: rtol 1e-6 there, as
  ``test_torch_sparsify.py::test_dense_allreduce_reference_matches_jax``,
  with the coordinates that nobody sent (``den == 0``) exact.
* ``RegTopK._score`` with ``omega_prev``: the per-coordinate omega equal
  in bits, the score to rtol 1e-6 (XLA:CPU's and PyTorch's tanh differ
  in the last ulp), and ``omega_prev`` of ones the scalar path bit for
  bit.
* ``compact_finalize`` and ``compact_finalize_sent`` with ``den``: the
  new state equal in bits, ``sent_w = den[idx]``, and
  ``convert.compact_state_from_jax`` carries it across.
* ``fastpath.leaf_fused`` under tables of equal rates (both packages'
  defaults) makes the JAX package's decisions on a grid of shapes,
  codecs, collectives and configs; ``ThroughputTable.measure`` on the CPU
  gives a finite table; ``build_plan`` routes ``"auto"`` through it.
"""
import dataclasses
import itertools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import codec as jcodec
from repro.comm import collectives as jcoll
from repro.comm import fastpath as jfp
from repro.core import compact as jc
from repro.core import sparsify as jsp
from repro_torch.comm import codec as tcodec
from repro_torch.comm import collectives as tcoll
from repro_torch.comm import fastpath as tfp
from repro_torch.convert import compact_state_from_jax, dense_state_from_jax
from repro_torch.core import compact as tc
from repro_torch.core import distributed as td
from repro_torch.core import sparsify as tsp
import _torch_cores  # noqa: F401  (this worker's share of the cores)


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def _payloads(seed, n, L, k):
    """``[n, k]`` payloads with distinct indices per worker, overlapping
    across workers, and an index-0 padding tail of +0.0."""
    rng = np.random.default_rng(seed)
    pool = rng.choice(L, 3 * k, replace=False)
    idx = np.stack([rng.choice(pool, k, replace=False) for _ in range(n)]).astype(np.int32)
    vals = rng.standard_normal((n, k)).astype(np.float32)
    vals[:, -3:] = 0.0
    idx[:, -3:] = 0
    vals[1, 0] = 1e-9  # quantizes to 0 under coo_q8: no sender mass there
    return vals, idx


@pytest.mark.parametrize("collective", sorted(tcoll.COLLECTIVES))
@pytest.mark.parametrize("name", sorted(tcodec.CODECS))
@pytest.mark.parametrize("n,L,scalar", [(5, 300, False), (8, 3 * 8192 + 17, True)])
def test_reference_coord_bits_match_jax(name, collective, n, L, scalar):
    vals, idx = _payloads(L + n, n, L, 40)
    rng = np.random.default_rng(n)
    w = rng.random(n).astype(np.float32)
    w /= w.sum()
    jw, tw = (1.0 / n, 1.0 / n) if scalar else (jnp.asarray(w), torch.from_numpy(w))
    jcd, tcd = jcodec.get_codec(name), tcodec.get_codec(name)
    jpay = jax.vmap(lambda v, i: jcd.encode(v, i, L))(jnp.asarray(vals), jnp.asarray(idx))
    tpay = tcd.encode(torch.from_numpy(vals), torch.from_numpy(idx).long(), L)
    jagg, jden = jcoll.get_collective(collective).reference_coord(jcd, jpay, jw, L)
    tagg, tden = tcoll.get_collective(collective).reference_coord(tcd, tpay, tw, L)
    want = jcoll.get_collective(collective).reference(jcd, jpay, jw, L)
    got = tcoll.get_collective(collective).reference(tcd, tpay, tw, L)
    pairs = ((tagg, jagg), (tden, jden), (got, want))
    if collective == "dense_allreduce":
        for t, j in pairs:
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6, atol=1e-12)
        np.testing.assert_array_equal(tden.numpy() == 0, np.asarray(jden) == 0)
    else:
        for t, j in pairs:
            np.testing.assert_array_equal(_bits(t.numpy()), _bits(j))
    if name == "coo_q8":  # a value that quantizes to zero: no sender mass
        dvals, _ = tcd.decode(tpay, L)
        assert float(dvals[1, 0]) == 0.0 and float(vals[1, 0]) != 0.0


def test_check_weighting_matches_jax():
    assert tcoll.WEIGHTINGS == jcoll.WEIGHTINGS
    with pytest.raises(ValueError) as want:
        jcoll.check_weighting("per-worker")
    with pytest.raises(ValueError) as got:
        tcoll.check_weighting("per-worker")
    assert str(got.value) == str(want.value)


N, L = 3, 96


def _cfg(**kw):
    return tsp.SparsifierConfig(kind="regtopk", sparsity=0.1, mu=2.0,
                                omega=1.0 / N, **kw)


@pytest.mark.parametrize("y", [1.0, 2.0])
def test_score_with_omega_prev_matches_jax(y):
    """From the JAX sparsifier's own state after two rounds, converted."""
    rng = np.random.default_rng(int(y))
    cfg = _cfg(y=y)
    jsp_ = jsp.make_sparsifier(jsp.SparsifierConfig(**dataclasses.asdict(cfg)))
    jst = jax.tree.map(lambda x: jnp.broadcast_to(x, (N,) + x.shape), jsp_.init(L))
    for _ in range(2):
        g = jnp.asarray(rng.standard_normal((N, L)).astype(np.float32))
        _, _, jst = jax.vmap(lambda s, x: jsp_.step(s, x, jnp.zeros(L)))(jst, g)
    st = dense_state_from_jax(jax.tree.map(np.asarray, jst), device="cpu")
    a = torch.from_numpy(rng.standard_normal((N, L)).astype(np.float32))
    g_prev = torch.from_numpy(rng.standard_normal(L).astype(np.float32))
    den = rng.random(L).astype(np.float32)
    den[::7] = 0.0  # nobody sent these: the guard value 1
    omega_prev = torch.from_numpy(den)
    sp = tsp.make_sparsifier(cfg)
    got = sp._score(st, a, g_prev, omega_prev)
    want = jax.vmap(lambda s, x: jsp_._score(s, x, jnp.asarray(g_prev.numpy()),
                                              jnp.asarray(den)))(jst, jnp.asarray(a.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    jomega = cfg.omega / jnp.where(jnp.asarray(den) > 0, jnp.asarray(den), 1.0)
    w = torch.where(omega_prev > 0, omega_prev, 1.0)
    np.testing.assert_array_equal(
        _bits((torch.full_like(w, cfg.omega) / w).numpy()), _bits(jomega))
    ones = sp._score(st, a, g_prev, torch.ones(L))
    assert torch.equal(ones, sp._score(st, a, g_prev))
    # the step threads omega_prev into the score, and its masks match
    ghat, mask, _ = sp.step(st, a, g_prev, omega_prev=omega_prev)
    jghat, jmask, _ = jax.vmap(lambda s, x: jsp_.step(
        s, x, jnp.asarray(g_prev.numpy()), omega_prev=jnp.asarray(den)))(
        jst, jnp.asarray(a.numpy()))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))


def test_compact_finalize_with_den_matches_jax_bits():
    W, n, k = 2, 500, 12
    rng = np.random.default_rng(4)
    st = tc.compact_init(W, n, k, device="cpu")
    g = torch.from_numpy(rng.standard_normal((W, n)).astype(np.float32))
    cfg = tsp.SparsifierConfig(kind="regtopk", sparsity=k / n, mu=1.0, omega=0.5)
    a, vals, idx = tc.compact_select(cfg, st, g, k)
    agg = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    den = torch.from_numpy((0.5 * rng.integers(0, 3, n)).astype(np.float32))
    sent_dense = torch.zeros_like(a).scatter_add_(1, idx, 0.9 * vals)
    new = tc.compact_finalize(st, a, vals, idx, agg, den=den)
    new_sent = tc.compact_finalize_sent(st, a, 0.9 * vals, idx, sent_dense, agg, den=den)
    wants = []
    for w in range(W):
        jst = jc.CompactState(
            eps=jnp.asarray(st.eps[w].numpy()), sent_vals=jnp.asarray(st.sent_vals[w].numpy()),
            sent_g=jnp.asarray(st.sent_g[w].numpy()),
            sent_idx=jnp.asarray(st.sent_idx[w].numpy(), jnp.int32),
            sent_w=jnp.asarray(st.sent_w[w].numpy()), t=jnp.asarray(st.t[w].numpy()))
        ja, jv, ji = (jnp.asarray(x[w].numpy()) for x in (a, vals, idx))
        want = jc.compact_finalize(jst, ja, jv, ji, jnp.asarray(agg.numpy()),
                                   den=jnp.asarray(den.numpy()))
        want_sent = jc.compact_finalize_sent(
            jst, ja, 0.9 * jv, ji, jnp.asarray(sent_dense[w].numpy()),
            jnp.asarray(agg.numpy()), den=jnp.asarray(den.numpy()))
        for got, exp in ((new, want), (new_sent, want_sent)):
            for name in ("eps", "sent_vals", "sent_g", "sent_w"):
                np.testing.assert_array_equal(
                    _bits(getattr(got, name)[w].numpy()),
                    _bits(getattr(exp, name)), err_msg=name)
            np.testing.assert_array_equal(got.sent_idx[w].numpy(), np.asarray(exp.sent_idx))
        wants.append(want)
    assert torch.equal(new.sent_w, den[idx])
    # the JAX states, stacked and converted, carry sent_w across
    conv = compact_state_from_jax(
        jax.tree.map(lambda *x: np.stack([np.asarray(v) for v in x]), *wants), device="cpu")
    for name in conv._fields:
        assert torch.equal(getattr(conv, name), getattr(new, name)), name
    assert torch.equal(tc.compact_finalize(st, a, vals, idx, agg).sent_w,
                       torch.ones(W, k))


_SCFGS = [
    tsp.SparsifierConfig(kind="regtopk", sparsity=0.01, mu=1.0),
    tsp.SparsifierConfig(kind="topk", sparsity=0.01),
    tsp.SparsifierConfig(kind="regtopk", sparsity=0.01, mu=1.0, selector="threshold"),
    tsp.SparsifierConfig(kind="regtopk", sparsity=0.01, mu=1e9),
]


def test_leaf_fused_matches_jax_under_equal_rates():
    """Both default tables have equal rates (the port's: kernel 2's rate on
    the card; the JAX package's: a TPU memory rate), so both decide on the
    bytes alone; so does any table of equal rates."""
    assert tfp.ThroughputTable().fused_bps == tfp.ThroughputTable().unfused_bps
    lengths = [100, 1000, 8192, 8193, 65536, 3 * 8192 + 17, 1 << 20, 4_458_752]
    seen = set()
    for L, frac, name, coll, mode, scfg in itertools.product(
        lengths, (0.001, 0.01, 0.1), sorted(tcodec.CODECS), sorted(tcoll.COLLECTIVES),
        tfp.FASTPATH_MODES, _SCFGS,
    ):
        k = max(1, math.ceil(frac * L))
        jcfg = jsp.SparsifierConfig(**dataclasses.asdict(scfg))
        for ttab, jtab in ((None, None),
                           (tfp.ThroughputTable(1e9, 1e9), jfp.ThroughputTable(1e9, 1e9))):
            got = tfp.leaf_fused(mode, name, coll, L, k, ttab, scfg=scfg)
            want = jfp.leaf_fused(mode, name, coll, L, k, jtab, scfg=jcfg)
            assert got == want, (L, k, name, coll, mode, scfg)
            seen.add(got)
        assert tfp.wire_fusable(tcodec.get_codec(name), coll) == jfp.wire_fusable(name, coll)
    assert seen == {True, False}
    assert tfp.unfused_hbm_bytes(65536, 64) == jfp.unfused_hbm_bytes(65536, 64)
    assert tfp.fused_hbm_bytes(65536, 64) == jfp.fused_hbm_bytes(65536, 64)
    with pytest.raises(ValueError, match="unknown fastpath mode"):
        tfp.leaf_fused("always", "coo_fp32", "sparse_allgather", 100, 4)


def test_measure_on_the_cpu_gives_a_finite_table():
    t = tfp.ThroughputTable.measure(length=8192, k=16, iters=2, device="cpu")
    assert math.isfinite(t.fused_bps) and t.fused_bps > 0
    assert math.isfinite(t.unfused_bps) and t.unfused_bps > 0
    assert isinstance(t.prefers_fused(8192, 16), bool)


@pytest.mark.parametrize("codec", ["coo_fp32", "coo_q8", "bitmap_dense"])
def test_build_plan_routes_auto_through_leaf_fused(monkeypatch, codec):
    """``"auto"`` fuses nothing on the CPU; where the device can run the
    kernel (here pretended), each leaf is fused as ``leaf_fused`` under the
    given table decides, which is the JAX package's decision."""
    shapes = {"big": (3 * 8192 + 17,), "small": (4, 33), "wide": (1 << 16,)}
    params = {n: torch.zeros(s) for n, s in shapes.items()}
    dist = td.DistConfig(sparsifier=_SCFGS[0], codec=codec, fastpath="auto")
    assert not any(p.fused for p in td.build_plan(params, 0.01, dist).values())
    monkeypatch.setattr(tfp, "backend_supports", lambda device: True)
    for table in (None, tfp.ThroughputTable(1.0, 1e30), tfp.ThroughputTable(1e30, 1.0)):
        plan = td.build_plan(params, 0.01, dist, table)
        jtab = None if table is None else jfp.ThroughputTable(table.fused_bps, table.unfused_bps)
        for n, p in plan.items():
            assert p.fused == jfp.leaf_fused(
                "auto", codec, "sparse_allgather", p.local_len, p.k, jtab,
                scfg=jsp.SparsifierConfig(**dataclasses.asdict(_SCFGS[0]))), (n, table)
    coord = dataclasses.replace(dist, weighting="coordinate")
    assert not any(p.fused for p in td.build_plan(params, 0.01, coord).values())
    with pytest.raises(ValueError, match="scalar omega"):
        dataclasses.replace(coord, fastpath="on").resolved_fastpath()
