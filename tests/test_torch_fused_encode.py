"""The port's fused select→encode pipeline against the JAX package's.

The port's plain version (``fused_candidates_ref``, which its wrapper
computes for a CPU tensor) and ``select_from_candidates`` are held against
``repro.kernels.fused_encode.fused_candidates(..., interpret=True)`` and
its ``select_from_candidates`` on the same numpy inputs. Indices and the
certificate must match exactly; scores and values agree to rtol 1e-6,
because XLA:CPU's and PyTorch's tanh and pow differ in the last ulp.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import fused_encode as jfe
from repro.kernels import ops as jops
from repro_torch.kernels import fused_encode as tfe
from repro_torch.kernels import ops as tops
import _torch_cores  # noqa: F401  (this worker's share of the cores)

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



def _bits_equal(j, t):
    """JAX candidate triples against the port's worker 0, in f32 bits."""
    for jx, tx in zip(j, t, strict=True):
        np.testing.assert_array_equal(
            tx[0].numpy().view(np.uint32), np.asarray(jx).view(np.uint32)
        )


@pytest.mark.parametrize("m", [4, 8])
@pytest.mark.parametrize("swap", [False, True])
def test_signed_zero_values_match_jax_bits(swap, m):
    """Zero scores picked as candidates: the TPU body emits the a-value as
    a masked sum, so an a of -0.0 comes out as +0.0, and the port's plain
    version gives the same bits. One tile of zeros, -0.0 at 3 and 7 and
    +0.0 at 5 (swapped signs too), 2.0 at 100; nothing sent, so the score
    is |a| exactly in both stacks."""
    n = 8192
    inner, outer = (np.float32(0.0), np.float32(-0.0))
    if swap:
        inner, outer = outer, inner
    a = np.full(n, outer, np.float32)
    a[5] = inner
    a[100] = 2.0
    zeros = np.zeros(n, np.float32)
    (jc, _), (tc, _) = _both([a, zeros, zeros, zeros], 1, m, 1.0)
    _bits_equal(jc, tc)
    assert (tc[1][0, 0, 1:].view(torch.int32) == 0).all()


def test_signed_zero_gradient_matches_jax_bits():
    """A gradient with fewer nonzero entries than the budget: -0.0 entries
    are selected as candidates, and their a-values come out as +0.0 in
    both stacks, bit for bit."""
    n, m = 3 * 8192, 16
    rng = np.random.default_rng(17)
    a = np.where(rng.random(n) < 0.5, np.float32(-0.0), np.float32(0.0))
    a = a.astype(np.float32)
    a[rng.choice(n, 20, replace=False)] = rng.standard_normal(20)
    zeros = np.zeros(n, np.float32)
    (jc, jsel), (tc, tsel) = _both([a, zeros, zeros, zeros], 12, m, 1.0)
    _bits_equal(jc, tc)
    picked = tc[2][0].long().reshape(-1)
    assert bool((torch.from_numpy(a)[picked].view(torch.int32) < 0).any())
    np.testing.assert_array_equal(tsel[1][0].numpy(), np.asarray(jsel[1]))


def test_zero_score_candidates_never_certify():
    """``select_from_candidates`` multiplies the candidate values by
    ``top_s > 0``, which keeps the sign of a negative value whose score is
    zero (-0.0 in the port, +0.0 in the JAX package). It cannot reach the
    wire: a zero among the top-k scores makes tau zero, and tau = 0 never
    certifies, so the dense path answers, and that payload equals the JAX
    package's in f32 bits. Here y = 2 and the tiny negative entries of the
    gradient square to zero scores."""
    from repro.core import compact as jc
    from repro.core.sparsify import SparsifierConfig as JaxConfig
    from repro_torch.comm.fastpath import fused_compact_select
    from repro_torch.core import compact as tc
    from repro_torch.core.sparsify import SparsifierConfig

    n, m, k = 8192, 8, 6
    a = np.zeros(n, np.float32)
    a[[3, 50, 700]] = [2.0, -3.0, 4.0]
    a[[0, 1, 2]] = -1e-25  # the lowest indices: the zero scores picked first
    zeros = np.zeros(n, np.float32)
    (_, (jv, _, jok)), (_, (tv, _, tok)) = _both([a, zeros, zeros, zeros], k, m, 2.0)
    assert not bool(jok) and not bool(tok[0])
    assert (tv[0].view(torch.int32) == np.int32(-2**31)).any()

    cfg = SparsifierConfig(kind="regtopk", sparsity=k / n, mu=MU, y=2.0, omega=OMEGA)
    st = tc.compact_init(1, n, k, device="cpu")._replace(
        t=torch.ones(1, dtype=torch.int32), sent_w=torch.ones(1, k))
    _, vals, idx = fused_compact_select(cfg, st, torch.from_numpy(a)[None], k)
    jst = jc.CompactState(
        eps=jnp.zeros(n), sent_vals=jnp.zeros(k), sent_g=jnp.zeros(k),
        sent_idx=jnp.zeros(k, jnp.int32), sent_w=jnp.ones(k),
        t=jnp.ones((), jnp.int32))
    import dataclasses
    _, jvals, jidx = jc.compact_select(
        JaxConfig(**dataclasses.asdict(cfg)), jst, jnp.asarray(a), k)
    np.testing.assert_array_equal(idx[0].numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(
        vals[0].numpy().view(np.uint32), np.asarray(jvals).view(np.uint32))
    assert idx[0, 3:].tolist() == [0, 1, 2]
    assert (vals[0].view(torch.int32)[3:] == 0).all()


@pytest.mark.parametrize("length,fusable", [
    (2**31 - 8192, True), (2**31 - 1, True), (2**31, False),
    (40 * 5120 * 17920, False),  # phi3-medium-14b's stacked layers.mlp.wg
])
def test_shape_fusable_refuses_leaves_beyond_int32(length, fusable):
    """Kernel 1 writes int32 flat indices, so a leaf of 2**31 elements or
    more stays unfused, with a reason (lengths only: no tensor is made);
    ``leaf_fused`` follows, ``build_plan`` (over shapes on the meta device)
    fuses the shorter leaves and refuses the longer one on the int32 wire
    of ``coo_fp32`` (``MAX_WIRE_LEN``), and a plan that marks such a leaf
    fused is refused."""
    from repro_torch.comm import fastpath as fp
    from repro_torch.core import distributed as td
    from repro_torch.core.sparsify import SparsifierConfig

    k = max(1, length // 1000)
    ok, why = fp.shape_fusable(length, k)
    assert ok == fusable
    if not fusable:
        assert why == f"a {length}-element leaf has flat indices beyond int32"
    assert fp.leaf_fused("on", "coo_fp32", "sparse_allgather", length, k) == fusable
    dist = td.DistConfig(sparsifier=SparsifierConfig(kind="regtopk",
                                                     sparsity=0.001),
                         fastpath="on")
    leaf = {"w": torch.empty(length, device="meta")}
    if fusable:
        assert td.build_plan(leaf, 0.001, dist)["w"].fused
    else:
        with pytest.raises(ValueError, match="MAX_WIRE_LEN"):
            td.build_plan(leaf, 0.001, dist)
        plan = td.build_plan(leaf, 0.001)  # no wire: the shapes alone
        with pytest.raises(ValueError, match="beyond int32"):
            td.make_sparsify_aggregate(
                {"w": plan["w"]._replace(fused=True)}, dist, 2)


def test_phi3_plan_keeps_its_largest_leaves_unfused():
    """At full depth phi3-medium-14b's stacked MLP leaves hold 3.67e9
    elements each: kernel 1's guard (``leaf_fused`` under ``--fastpath
    on``) keeps them unfused and fuses the rest, and ``build_plan`` refuses
    them on the int32 wire of ``coo_fp32``, naming the limit."""
    from repro_torch import configs
    from repro_torch.comm import fastpath as fp
    from repro_torch.core import distributed as td
    from repro_torch.core.sparsify import SparsifierConfig
    from repro_torch.models import lm
    from repro_torch.tree import tree_items

    params = lm.init(configs.get_config("phi3-medium-14b"), device="meta")
    dist = td.DistConfig(sparsifier=SparsifierConfig(kind="regtopk",
                                                     sparsity=0.001),
                         fastpath="on")
    plan = dict(tree_items(td.build_plan(params, 0.001)))  # the shapes
    unfused = sorted(path for path, p in plan.items() if not fp.leaf_fused(
        "on", dist.codec, "sparse_allgather", p.local_len, p.k))
    assert unfused == ["layers.mlp.wd", "layers.mlp.wg", "layers.mlp.wu"]
    assert all(p.local_len >= 2**31 for path, p in plan.items()
               if path in unfused)
    with pytest.raises(ValueError, match="MAX_WIRE_LEN") as e:
        td.build_plan(params, 0.001, dist)
    assert "3670016000 elements" in str(e.value)
