"""The port's adaptive-k controller and its dynamic-k selection against
the JAX package's ``repro.comm.controller``.

* ``bounds``, ``init``, ``plan_k`` (against the jitted law) and
  ``round_wire_bits`` give JAX's answers, exactly; ``parse_adaptive_k`` and the config checks raise
  JAX's errors;
* ``observe`` over a 60-round numpy trajectory of norms: the k trajectory
  exactly, ``err_ratio`` to rtol 1e-5 (the jitted JAX law and the port
  differ in the last bit in a few of the 60 rounds);
* ``selectors.exact_topk_mask_dynamic`` equals JAX's at every k, and
  ``exact_topk_mask`` in bits at ``k == capacity``;
* ``Sparsifier.step_dyn`` (topk, regtopk) equals JAX's vmapped
  ``step_dyn`` in bits on the masks and the state;
* ``compact_select(k_dyn=...)`` against the jitted JAX function in f32
  bits, negative values included: under ``jax.jit`` the JAX package's
  ``_apply_k_dyn`` zeroes the tail as +0.0 (eagerly its product gives
  -0.0), so the port selects the value with ``torch.where``; fused (the
  kernel wrapper's plain version on the CPU) and unfused alike;
* at ``k_dyn == k`` every path is the static one bit for bit; kinds and
  selectors without a dynamic k raise.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import controller as jctl
from repro.core import compact as jc
from repro.core import selectors as jsel
from repro.core import sparsify as jsp
from repro_torch.comm import controller as tctl
from repro_torch.core import compact as tc
from repro_torch.core import selectors as tsel
from repro_torch.core import sparsify as tsp
import _torch_cores  # noqa: F401  (this worker's share of the cores)


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


CONTROLLERS = [
    dict(budget=0.5), dict(budget=0.1, k_min=0.01, k_max=64),
    dict(budget=1.0, k_min=0.001, k_max=0.012), dict(budget=0.3, k_min=4, k_max=4),
    dict(budget=0.2, k_min=0.5, k_max=3, hysteresis=0.0, gain=1.5, momentum=0.0),
]


@pytest.mark.parametrize("kw", CONTROLLERS)
def test_bounds_and_init_match_jax(kw):
    tc_, jc_ = tctl.AdaptiveKController(**kw), jctl.AdaptiveKController(**kw)
    for length in (1, 3, 7, 100, 1000, 4_458_752 // 11):
        def outcome(c):
            try:
                return c.bounds(length)
            except ValueError as e:
                return str(e)
        assert outcome(tc_) == outcome(jc_)
        if isinstance(outcome(jc_), tuple):
            lo, hi = jc_.bounds(length)
            for k0 in (0, lo, hi, hi + 5):
                got, want = tc_.init(k0, lo, hi, device="cpu"), jc_.init(k0, lo, hi)
                assert got.k.dtype == torch.int32 and got.err_ratio.dtype == torch.float32
                assert (int(got.k), int(got.t), float(got.err_ratio)) == (
                    int(want.k), int(want.t), float(want.err_ratio))


@pytest.mark.parametrize("kw", [
    dict(budget=0.0), dict(budget=0.1, momentum=1.0), dict(budget=0.1, momentum=-0.1),
    dict(budget=0.1, hysteresis=-1.0), dict(budget=0.1, gain=1.0),
    dict(budget=0.1, k_min=0.0), dict(budget=0.1, k_min=8, k_max=4),
    dict(budget=0.1, k_min=0.5, k_max=0.25),
])
def test_bad_controllers_raise_as_jax(kw):
    with pytest.raises(ValueError) as want:
        jctl.AdaptiveKController(**kw)
    with pytest.raises(ValueError) as got:
        tctl.AdaptiveKController(**kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kw", CONTROLLERS)
def test_plan_k_matches_jax(kw):
    """Every k on a grid of ratios around the dead band's edges, the gain
    clamps and the bounds, against the JAX law under ``jax.jit`` (as its
    simulator and trainer run it: ``ratio / budget`` is then ``ratio *
    fl(1/budget)``)."""
    tc_, jc_ = tctl.AdaptiveKController(**kw), jctl.AdaptiveKController(**kw)
    b, h, g = jc_.budget, jc_.hysteresis, jc_.gain
    ratios = np.float32([0.0, b * 1e-3, b / g, b * (1 - h), b, b * (1 + h),
                         b * (1 + h) * 1.0000001, b * g, b * 10, 3.7e-2, 1.3])
    rng = np.random.default_rng(1)
    ratios = np.concatenate([ratios, rng.uniform(0, 3 * b, 200).astype(np.float32)])
    for lo, hi in ((1, 256), (3, 40), (7, 7)):
        for k in (1, 2, 3, 5, 16, 17, 40, 255, 256):
            got = [int(tc_.plan_k(torch.tensor(r), torch.tensor(k, dtype=torch.int32),
                                  lo, hi)) for r in ratios]
            want = np.asarray(jax.jit(jax.vmap(
                lambda r: jc_.plan_k(r, jnp.asarray(k, jnp.int32), lo, hi)))(
                    jnp.asarray(ratios)))
            np.testing.assert_array_equal(got, want, err_msg=f"k={k} [{lo}, {hi}]")


@pytest.mark.parametrize("kw", CONTROLLERS[:3])
def test_observe_trajectory_matches_jax(kw):
    """60 rounds of numpy norms through ``observe``, jitted on the JAX side
    as its simulator and trainer run it."""
    tc_, jc_ = tctl.AdaptiveKController(**kw), jctl.AdaptiveKController(**kw)
    lo, hi = jc_.bounds(5000)
    rng = np.random.default_rng(2)
    eps = rng.uniform(0.0, 2.0, 60).astype(np.float32) * jc_.budget
    gn = rng.uniform(0.5, 1.5, 60).astype(np.float32)
    gn[7] = 0.0  # the tiny floor
    tst, jst = tc_.init(10, lo, hi, device="cpu"), jc_.init(10, lo, hi)
    jobs = jax.jit(lambda s, e, g: jc_.observe(s, e, g, k_min=lo, k_max=hi))
    ks = []
    for e, g in zip(eps, gn, strict=True):
        tst = tc_.observe(tst, torch.tensor(e), torch.tensor(g), k_min=lo, k_max=hi)
        jst = jobs(jst, jnp.asarray(e), jnp.asarray(g))
        assert int(tst.k) == int(jst.k) and int(tst.t) == int(jst.t)
        np.testing.assert_allclose(float(tst.err_ratio), float(jst.err_ratio),
                                   rtol=1e-5)
        ks.append(int(tst.k))
    assert len(set(ks)) > 1  # the trajectory moves


@pytest.mark.parametrize("codec", ["coo_fp32", "coo_idx_delta", "bitmap_dense", "coo_q8"])
def test_round_wire_bits_matches_jax(codec):
    for length, k in ((1000, 10), (4_458_752, 44_588), (300, 1), (300, 300)):
        assert tctl.round_wire_bits(codec, length, k) == jctl.round_wire_bits(
            codec, length, k)


@pytest.mark.parametrize("spec", [
    "0.1", "0.1,4,64", "1.0,0.001,0.012", " 0.5 , 1 , 0.25 ", "0.1,4", "a",
    "0.1,x,3", "0", "0.1,8,4",
])
def test_parse_adaptive_k_matches_jax(spec):
    def outcome(mod):
        try:
            return dataclasses.asdict(mod.parse_adaptive_k(spec))
        except ValueError as e:
            return str(e)
    assert outcome(tctl) == outcome(jctl)


def _scores(n, L, seed):
    rng = np.random.default_rng(seed)
    s = np.abs(rng.standard_normal((n, L))).astype(np.float32)
    s[:, :5] = 0.0  # zero scores are never selected
    s[0, 10:14] = s[0, 20]  # ties go to the lowest index
    return s


def test_dynamic_mask_matches_jax_and_the_static_mask_at_capacity():
    s = _scores(3, 64, 0)
    for cap in (1, 8, 40, 64, 80):
        for k in range(0, min(cap, 64) + 1, 3):
            got = tsel.exact_topk_mask_dynamic(torch.from_numpy(s), torch.tensor(k), cap)
            want = jax.vmap(lambda x: jsel.exact_topk_mask_dynamic(
                x, jnp.asarray(k), cap))(jnp.asarray(s))
            np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=f"{cap} {k}")
        at_cap = tsel.exact_topk_mask_dynamic(torch.from_numpy(s), torch.tensor(cap), cap)
        np.testing.assert_array_equal(
            _bits(at_cap), _bits(tsel.exact_topk_mask(torch.from_numpy(s), cap)))


def _dense_state(n, L, seed, t):
    rng = np.random.default_rng(seed)
    return dict(
        eps=rng.standard_normal((n, L)).astype(np.float32),
        a_prev=rng.standard_normal((n, L)).astype(np.float32),
        s_prev=(rng.uniform(size=(n, L)) < 0.2).astype(np.float32),
        t=np.full(n, t, np.int32),
    )


@pytest.mark.parametrize("kind", ["topk", "regtopk"])
@pytest.mark.parametrize("t", [0, 3])
def test_step_dyn_matches_jax(kind, t):
    n, L, cap = 3, 200, 20
    st = _dense_state(n, L, 4, t)
    rng = np.random.default_rng(5)
    g = rng.standard_normal((n, L)).astype(np.float32)
    g_prev = rng.standard_normal(L).astype(np.float32)
    cfg = dict(kind=kind, sparsity=0.05, mu=2.0, omega=0.25)
    tsparse = tsp.make_sparsifier(tsp.SparsifierConfig(**cfg))
    jsparse = jsp.make_sparsifier(jsp.SparsifierConfig(**cfg))
    tstate = tsp.DenseState(**{k: torch.from_numpy(v) for k, v in st.items()})
    # the JAX state from its own init's structure, slots in field order
    jstate = jax.tree.unflatten(jax.tree.structure(jsparse.init(L)), [
        jnp.asarray(st[name]) for name in ("eps", "a_prev", "s_prev", "t")])
    jstep = jax.jit(jax.vmap(
        lambda s, x, k: jsparse.step_dyn(s, x, jnp.asarray(g_prev), k, cap),
        in_axes=(0, 0, None)))
    for k in (0, 1, 7, cap):
        ghat, mask, new = tsparse.step_dyn(tstate, torch.from_numpy(g),
                                           torch.from_numpy(g_prev), torch.tensor(k), cap)
        jghat, jmask, jnew = jstep(jstate, jnp.asarray(g), jnp.asarray(k))
        np.testing.assert_array_equal(_bits(mask), _bits(jmask))
        np.testing.assert_array_equal(_bits(ghat), _bits(jghat))
        for name in ("eps", "a_prev", "s_prev"):
            np.testing.assert_array_equal(_bits(getattr(new, name)),
                                          _bits(getattr(jnew, name)), err_msg=name)
        assert int(mask.sum(-1).max()) == k
    # at k == capacity step_dyn is step, bit for bit
    s_cfg = tsp.SparsifierConfig(**dict(cfg, sparsity=cap / L))
    static = tsp.make_sparsifier(s_cfg).step(tstate, torch.from_numpy(g),
                                             torch.from_numpy(g_prev))
    dyn = tsp.make_sparsifier(s_cfg).step_dyn(
        tstate, torch.from_numpy(g), torch.from_numpy(g_prev), torch.tensor(cap), cap)
    for x, y in zip(static[:2], dyn[:2], strict=True):
        np.testing.assert_array_equal(_bits(x), _bits(y))


def test_step_dyn_refuses_other_kinds_and_selectors():
    z = torch.zeros(2, 8)
    st = tsp.DenseState(z, z, z, torch.zeros(2, dtype=torch.int32))
    with pytest.raises(NotImplementedError, match="dynamic per-round k"):
        tsp.make_sparsifier(tsp.SparsifierConfig(kind="dgc")).step_dyn(
            st, z, z[0], torch.tensor(1), 2)
    with pytest.raises(ValueError, match="selector='exact'"):
        tsp.make_sparsifier(tsp.SparsifierConfig(kind="topk", selector="threshold")
                            ).step_dyn(st, z, z[0], torch.tensor(1), 2)


L_C, K_C = 3 * 8192 + 17, 64


def _compact_inputs(W, t, seed):
    """A compact state after ``t`` rounds and this round's gradients, all
    from numpy; negative accumulated values make the tail's zeros signed."""
    rng = np.random.default_rng(seed)
    eps = rng.standard_normal((W, L_C)).astype(np.float32)
    g = rng.standard_normal((W, L_C)).astype(np.float32)
    idx = np.stack([rng.choice(L_C, K_C, replace=False) for _ in range(W)])
    st = dict(eps=eps, sent_vals=rng.standard_normal((W, K_C)).astype(np.float32),
              sent_g=rng.standard_normal((W, K_C)).astype(np.float32),
              sent_idx=idx, sent_w=np.ones((W, K_C), np.float32),
              t=np.full(W, t, np.int32))
    return st, g


@pytest.mark.parametrize("kind", ["topk", "regtopk"])
@pytest.mark.parametrize("t", [0, 2])
@pytest.mark.parametrize("fastpath", ["off", "on"])
def test_compact_select_k_dyn_matches_jitted_jax_bits(kind, t, fastpath):
    W = 2
    st, g = _compact_inputs(W, t, 7 + t)
    cfg = dict(kind=kind, sparsity=K_C / L_C, mu=1.0, omega=0.5)
    tstate = tc.CompactState(
        **{k: torch.from_numpy(v).long() if k == "sent_idx" else torch.from_numpy(v)
           for k, v in st.items()})
    tcfg, jcfg = tsp.SparsifierConfig(**cfg), jsp.SparsifierConfig(**cfg)
    jsel_fn = jax.jit(
        lambda s, x, kd: jc.compact_select(jcfg, s, x, K_C, k_dyn=kd),
        static_argnums=())
    negative_tail = False
    for k_dyn in (0, 1, 13, K_C - 1, K_C):
        a, vals, idx = tc.compact_select(
            tcfg, tstate, torch.from_numpy(g), K_C, k_dyn=torch.tensor(k_dyn),
            fastpath=fastpath)
        for w in range(W):
            js = jc.CompactState(**{k: jnp.asarray(v[w]) for k, v in st.items()})
            ja, jv, ji = jsel_fn(js, jnp.asarray(g[w]), jnp.asarray(k_dyn))
            np.testing.assert_array_equal(idx[w].numpy(), np.asarray(ji))
            np.testing.assert_array_equal(_bits(vals[w]), _bits(jv), err_msg=f"k={k_dyn}")
            np.testing.assert_array_equal(_bits(a[w]), _bits(ja))
            tail = a[w][idx[w][k_dyn:]]
            negative_tail |= bool((tail < 0).any())
        assert not torch.signbit(vals[:, k_dyn:]).any()
    assert negative_tail  # the signed-zero case was exercised
    # at k_dyn == k the payload is the static path's
    static = tc.compact_select(tcfg, tstate, torch.from_numpy(g), K_C, fastpath=fastpath)
    for x, y in zip(static, (a, vals, idx), strict=True):
        assert torch.equal(x, y)


def test_compact_select_k_dyn_refuses_other_kinds():
    st, g = _compact_inputs(1, 1, 0)
    tstate = tc.CompactState(
        **{k: torch.from_numpy(v).long() if k == "sent_idx" else torch.from_numpy(v)
           for k, v in st.items()})
    for cfg in (tsp.SparsifierConfig(kind="cyclic"),
                tsp.SparsifierConfig(kind="regtopk", selector="threshold")):
        with pytest.raises(ValueError, match="dynamic per-round k"):
            tc.compact_select(cfg, tstate, torch.from_numpy(g), K_C,
                              k_dyn=torch.tensor(3))
