"""Divisions by a constant, held against the JAX package under ``jax.jit``.

Under ``jit`` XLA:CPU computes ``x / c`` for a constant ``c`` as ``x *
fl(1/c)``, and reduces a short vector in index order; eagerly JAX divides.
The JAX simulator and trainer run jitted, so the port computes what the
jitted reference computes (``kernels.regtopk_score.const_div`` and
``ordered_mean``), in f32 bits, at worker counts that are not powers of
two:

* ``coo_q8``'s scale ``amax / 127.0``;
* the controller's pressure ``err_ratio / budget`` (``plan_k``);
* the simulator's and the trainer's mean ``||eps||`` over the workers
  (``.mean()``, ``pmean``), kind ``none``'s ``pmean`` of the gradients,
  and the trainer's ``adaptive_k`` metric (the mean of the leaves' k).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.comm import codec as jcodec
from repro.comm import controller as jctl
from repro.core import compact as jc
from repro.core import distributed as jd
from repro.core.sparsify import SparsifierConfig as JaxSparsifierConfig
from repro_torch.comm import codec as tcodec
from repro_torch.comm import controller as tctl
from repro_torch.core import distributed as td
from repro_torch.core.sparsify import SparsifierConfig
from repro_torch.kernels.regtopk_score import const_div, ordered_mean


AXIS = "data"  # the workers' vmap axis, the JAX trainer's dp axis name


def _pmean(v, axis):
    return jax.lax.pmean(v, axis)


def _jit_div(c):
    """``v / c`` for the constant ``c``, jitted."""
    return jax.jit(lambda v: v / c)


def _jit_mean_of_stack():
    """The JAX trainer's ``adaptive_k`` metric over rows of leaf ks,
    jitted."""
    return jax.jit(jax.vmap(
        lambda k: jnp.stack([jnp.asarray(x, jnp.float32) for x in k]).mean()))


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def test_q8_scale_matches_jitted_jax_bits():
    """20,000 payloads of magnitudes 1e-3 … 1e3: the port's scale and int8
    codes equal the jitted JAX encode's; the eager encode (a true
    division) differs from both in some scales."""
    rng = np.random.default_rng(0)
    n, k = 20_000, 8
    vals = (rng.standard_normal((n, k))
            * rng.uniform(1e-3, 1e3, (n, 1))).astype(np.float32)
    idx = np.tile(np.arange(k, dtype=np.int32), (n, 1))
    enc = lambda v, i: jcodec.CooQ8().encode(v, i, 64)  # noqa: E731
    jit = jax.jit(jax.vmap(enc))(vals, idx)
    eager = jax.vmap(enc)(vals, idx)
    port = tcodec.CooQ8().encode(torch.from_numpy(vals),
                                 torch.from_numpy(idx).long(), 64)
    np.testing.assert_array_equal(_bits(port["scale"].numpy()), _bits(jit["scale"]))
    np.testing.assert_array_equal(port["q"].numpy(), np.asarray(jit["q"]))
    assert (_bits(eager["scale"]) != _bits(jit["scale"])).sum() > 0


def test_plan_k_matches_jitted_jax_at_the_boundary():
    """``budget=0.3``, ``err_ratio=0.52500004``, ``k=4``: the jitted JAX
    law plans 8 (the pressure ``0.52500004 * fl(1/0.3)`` lands above
    1.75, where ``ceil(4 * 1.75...)`` is 8); the eager law plans 7."""
    jc_, tc_ = jctl.AdaptiveKController(budget=0.3), tctl.AdaptiveKController(budget=0.3)
    e = np.float32(0.52500004)
    jit = jax.jit(lambda r, k: jc_.plan_k(r, k, 1, 100))
    assert int(jit(jnp.float32(e), jnp.int32(4))) == 8
    assert int(jc_.plan_k(jnp.float32(e), jnp.int32(4), 1, 100)) == 7
    assert int(tc_.plan_k(torch.tensor(e), torch.tensor(4, dtype=torch.int32),
                          1, 100)) == 8


@pytest.mark.parametrize("budget", [0.3, 0.7, 0.1, 1.0])
def test_plan_k_matches_jitted_jax_near_the_band(budget):
    """3,000 ratios within a few ulps of the dead band's edges and of the
    gain clamps, each k from 1 to 12: the k of the jitted JAX law."""
    jc_, tc_ = (jctl.AdaptiveKController(budget=budget),
                tctl.AdaptiveKController(budget=budget))
    edges = np.float32([budget * 0.75, budget * 1.25, budget / 2, budget * 2,
                        budget * 1.75, budget * 1.5])
    rng = np.random.default_rng(3)
    ratios = (np.repeat(edges, 500)
              * (1 + rng.integers(-8, 9, 3000) * 6e-8)).astype(np.float32)
    jplan = jax.jit(jax.vmap(lambda r, k: jc_.plan_k(r, k, 1, 10_000),
                             in_axes=(0, None)))
    for k in range(1, 13):
        want = np.asarray(jplan(ratios, jnp.int32(k)))
        got = tc_.plan_k(torch.from_numpy(ratios), torch.tensor(k, dtype=torch.int32),
                         1, 10_000).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"k={k}")


@pytest.mark.parametrize("W", [5, 20])
def test_worker_means_match_jitted_jax_bits(W):
    """``ordered_mean`` over W workers against the jitted ``.mean()`` of a
    W-vector (the simulator's mean ``||eps||``) and the jitted ``pmean``
    over a W-worker axis (the trainer's), in bits."""
    rng = np.random.default_rng(W)
    norms = (np.abs(rng.standard_normal((2000, W))) * 5).astype(np.float32)
    want = np.asarray(jax.jit(jax.vmap(lambda v: v.mean()))(norms))
    got = np.array([ordered_mean(torch.from_numpy(r)).item() for r in norms],
                   np.float32)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    x = (3 * rng.standard_normal((W, 4000))).astype(np.float32)
    want = np.asarray(jax.jit(jax.vmap(lambda v: _pmean(v, AXIS),
                                       axis_name=AXIS))(x))[0]
    np.testing.assert_array_equal(_bits(ordered_mean(torch.from_numpy(x)).numpy()),
                                  _bits(want))


def test_const_div_is_the_reciprocal_product():
    rng = np.random.default_rng(4)
    x = (rng.standard_normal(100_000) * 10).astype(np.float32)
    for c in (3.0, 127.0, 5.0, 20.0, 0.3, 11.0):
        want = np.asarray(_jit_div(c)(x))
        np.testing.assert_array_equal(_bits(const_div(torch.from_numpy(x), c).numpy()),
                                      _bits(want), err_msg=str(c))


def _jax_leaf_rounds(W, g, cfg, p, ctrl=None):
    """The JAX trainer's ``_spa_leaf`` (and ``_ctrl_update`` under
    ``ctrl``) for W workers under ``jax.jit(jax.vmap(axis_name=AXIS))``,
    as ``make_sparsify_aggregate`` runs them under ``shard_map``."""
    def one(gw, st, c):
        agg, new = jd._spa_leaf(gw, st, p, cfg, jcodec.get_codec("coo_fp32"),
                                "sparse_allgather", (AXIS,),
                                k_dyn=None if c is None else c.k)
        if c is None:
            return agg, new, None
        lo, hi = ctrl.bounds(p.local_len)
        return agg, new, jd._ctrl_update(ctrl, c, new, agg, p, (AXIS,), (), lo, hi)

    st = jc.compact_init(p.local_len, p.k)
    st = jc.CompactState(eps=st.eps[None], sent_vals=st.sent_vals[None, None],
                         sent_g=st.sent_g[None, None], sent_idx=st.sent_idx[None, None],
                         sent_w=st.sent_w[None, None], t=st.t[None])
    st = jax.tree.map(lambda x: jnp.stack([x] * W), st)
    c0 = None
    if ctrl is not None:
        c0 = ctrl.init(jd.sparsity_to_k(p.local_len, cfg.sparsity),
                       *ctrl.bounds(p.local_len))
    return jax.jit(jax.vmap(one, axis_name=AXIS, in_axes=(0, 0, None)))(
        jnp.asarray(g)[:, None], st, c0)


def test_kind_none_pmean_matches_jitted_jax_bits_at_five_workers():
    """Kind ``none`` sends the dense mean: at W = 5 the port's one-card
    aggregate equals the jitted JAX ``pmean`` in bits."""
    W, L = 5, 3000
    g = (np.random.default_rng(5).standard_normal((W, L)) * 2).astype(np.float32)
    jcfg = JaxSparsifierConfig(kind="none", sparsity=0.01, omega=1.0 / W)
    p = jd.LeafPlan((L,), (L,), L, 30, P(None))
    want = np.asarray(_jax_leaf_rounds(W, g, jcfg, p)[0])[0]
    dist = td.DistConfig(sparsifier=SparsifierConfig(kind="none", sparsity=0.01))
    plan = td.build_plan({"w": torch.zeros(L)}, 0.01, dist)
    agg, _ = td.make_sparsify_aggregate(plan, dist, W)(
        {"w": torch.from_numpy(g)}, td.init_sparsifier_state(plan, W, "cpu"))
    np.testing.assert_array_equal(_bits(agg["w"].numpy()), _bits(want))


@pytest.mark.parametrize("W", [5, 20])
def test_controller_update_matches_jitted_jax_bits(W):
    """``_ctrl_update`` at W workers against the jitted JAX one under a
    W-worker ``vmap`` axis: ``err_ratio`` in bits and k exactly. The
    errors and the aggregate hold small integers, so every norm's long sum
    is exact in both stacks and only the mean over the workers (``pmean``)
    can part them."""
    L = 4000
    rng = np.random.default_rng(W + 1)
    eps = rng.integers(-8, 9, (W, L)).astype(np.float32)
    agg = rng.integers(-3, 4, L).astype(np.float32)
    kw = dict(budget=0.3, k_min=0.001, k_max=0.05)
    jctrl, tctrl = jctl.AdaptiveKController(**kw), tctl.AdaptiveKController(**kw)
    lo, hi = jctrl.bounds(L)
    p = jd.LeafPlan((L,), (L,), L, hi, P(None))
    st = jc.compact_init(L, hi)

    def one(e, a):
        new = st._replace(eps=e[None])
        return jd._ctrl_update(jctrl, jctrl.init(40, lo, hi), new, a, p,
                               (AXIS,), (), lo, hi)

    # the aggregate is an operand: a closed-over constant would fold
    # ||g_agg|| and turn the ratio's division into a reciprocal product
    want = jax.jit(jax.vmap(one, axis_name=AXIS, in_axes=(0, None)))(
        jnp.asarray(eps), jnp.asarray(agg))
    tst = td.C.compact_init(W, L, hi, "cpu")._replace(eps=torch.from_numpy(eps))
    tp = td.LeafPlan((L,), L, hi)
    got = td._ctrl_update(tctrl, tctrl.init(40, lo, hi, device="cpu"), tst,
                          torch.from_numpy(agg), tp, None, W)
    np.testing.assert_array_equal(_bits(got.err_ratio.numpy()),
                                  _bits(np.asarray(want.err_ratio)[0]))
    assert int(got.k) == int(np.asarray(want.k)[0])


def test_adaptive_k_metric_matches_jitted_jax_bits():
    """The trainer's ``adaptive_k`` metric, the mean of the leaves' k,
    against the jitted JAX ``jnp.stack(ks).mean()`` over 11 leaves (the
    model's) and 7."""
    rng = np.random.default_rng(6)
    for n in (11, 7):
        ks = rng.integers(1, 50_000, (500, n)).astype(np.int32)
        want = np.asarray(_jit_mean_of_stack()(ks))
        got = np.array([const_div(torch.from_numpy(r).float().sum(), float(n)).item()
                        for r in ks], np.float32)
        np.testing.assert_array_equal(_bits(got), _bits(want))

