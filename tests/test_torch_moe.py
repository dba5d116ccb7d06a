"""The port's Mixture-of-Experts layer against ``repro.nn.moe``.

Weights come from the JAX package's ``moe_init`` and the tokens from
numpy; the JAX side runs under ``jax.jit``. ``moe_apply`` must match it
with both dispatches (``"einsum"``, ``"gather"``), with and without
shared experts, when tokens drop (``capacity_factor=0.5``), with
``no_drop``, and when the token count is not a multiple of the group
size, so that the zero-padded tail routes: the output to rtol 1e-5 with
an absolute floor of 1e-5 of its largest magnitude (float32 matmuls sum
in another order in XLA:CPU and PyTorch), the aux loss and every
gradient leaf of ``sum(y * r) + aux`` likewise.

The routing (expert indices, slot positions, keep mask) must be exact,
and the renormalized gates equal in f32 bits, against the JAX routing
(``lax.top_k``, the one-hot cumulative sum; ``src/repro/nn/moe.py``) on
well-separated probabilities, on all-equal ones (ties go to the lowest
expert) and on rows with ties.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn import moe as jmoe
from repro_torch import convert
from repro_torch.nn import moe as tmoe
from repro_torch.tree import tree_items
import _torch_cores  # noqa: F401  (this worker's share of the cores)

RTOL = 1e-5
D, F_, E = 32, 48, 4


def _close(got, want, msg=""):
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max(), err_msg=msg)


def _params(n_shared, seed=0):
    p, _ = jmoe.moe_init(jax.random.PRNGKey(seed), D, F_, E, n_shared=n_shared,
                         shared_d_ff=64 if n_shared else None)
    return p


CASES = {
    # name: (tokens B x S, group_size, capacity_factor, no_drop, top_k)
    "drops": ((2, 16), 16, 0.5, False, 2),
    "no_drop": ((2, 16), 16, 1.25, True, 2),
    "padded_tail": ((2, 21), 16, 1.25, False, 2),
    "padded_tail_drops": ((3, 7), 8, 0.5, False, 1),
    "one_group": ((1, 12), 4096, 1.25, False, 3),
}


@pytest.mark.parametrize("dispatch", ["einsum", "gather"])
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("n_shared", [0, 1])
def test_moe_apply_matches_jax(dispatch, case, n_shared):
    (B, S), group, cf, no_drop, top_k = CASES[case]
    jp = _params(n_shared)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    r = rng.standard_normal((B, S, D)).astype(np.float32)
    kw = dict(top_k=top_k, capacity_factor=cf, group_size=group,
              no_drop=no_drop, dispatch=dispatch)

    def jloss(p, x):
        y, aux = jmoe.moe_apply(p, x, **kw)
        return jnp.sum(y * r) + aux, (y, aux)

    (_, (jy, jaux)), (jgp, jgx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jp, jnp.asarray(x))

    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    live = {path: leaf.requires_grad_(True) for path, leaf in tree_items(tp)}
    tx = torch.from_numpy(x).requires_grad_(True)
    ty, taux = tmoe.moe_apply(tp, tx, **kw)
    (torch.sum(ty * torch.from_numpy(r)) + taux).backward()
    _close(ty.detach().numpy(), np.asarray(jy), "y")
    np.testing.assert_allclose(float(taux.detach()), float(jaux), rtol=RTOL)
    _close(tx.grad.numpy(), np.asarray(jgx), "x")
    for path, want in tree_items(jax.tree.map(np.asarray, jgp)):
        _close(live[path].grad.numpy(), want, path)


def _jax_route(probs, top_k, cap):
    """The JAX layer's routing of one group, op for op
    (``src/repro/nn/moe.py``, ``per_group``)."""
    g, n_exp = probs.shape
    gate_vals, gate_idx = jax.lax.top_k(probs, top_k)
    gate_vals = gate_vals / jnp.maximum(gate_vals.sum(-1, keepdims=True), 1e-9)
    flatoh = jax.nn.one_hot(gate_idx, n_exp, dtype=jnp.int32).reshape(
        g * top_k, n_exp)
    pos = jnp.cumsum(flatoh, axis=0) - flatoh
    pos = (pos * flatoh).sum(-1).reshape(g, top_k)
    return gate_vals, gate_idx, pos, pos < cap


def _probs(kind, g, n_exp, rng):
    if kind == "separated":
        logits = rng.permuted(np.tile(np.arange(n_exp, dtype=np.float32),
                                      (g, 1)), axis=1)
        e = np.exp(logits)
        return (e / e.sum(-1, keepdims=True)).astype(np.float32)
    if kind == "equal":
        return np.full((g, n_exp), np.float32(1.0) / n_exp, np.float32)
    # ties: a few values repeated within each row
    return rng.choice(np.float32([0.05, 0.1, 0.2]), (g, n_exp)).astype(np.float32)


@pytest.mark.parametrize("kind", ["separated", "equal", "ties"])
@pytest.mark.parametrize("g,n_exp,top_k,cap", [(16, 4, 2, 5), (64, 64, 6, 7),
                                              (9, 8, 2, 1)])
def test_routing_is_exact(kind, g, n_exp, top_k, cap):
    probs = _probs(kind, g, n_exp, np.random.default_rng(g + n_exp))
    want = jax.jit(_jax_route, static_argnums=(1, 2))(jnp.asarray(probs),
                                                      top_k, cap)
    got = tmoe.route(torch.from_numpy(probs), top_k, cap)
    np.testing.assert_array_equal(got[0].numpy().view(np.int32),
                                  np.asarray(want[0]).view(np.int32))
    for t, j, name in zip(got[1:], want[1:], ("idx", "pos", "keep"), strict=True):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=name)
    if kind == "equal":  # lowest expert first
        assert torch.equal(got[1], torch.arange(top_k).expand(g, top_k))


@pytest.mark.parametrize("dispatch", ["einsum", "gather"])
def test_zero_router_routes_lowest_experts_as_jax(dispatch):
    """A zero router gives every token equal probabilities: each takes
    experts 0..k-1, the first ``cap`` tokens keep their slots, and the
    layer matches JAX."""
    jp = dict(_params(1), router=jnp.zeros((D, E)))
    x = np.random.default_rng(1).standard_normal((2, 10, D)).astype(np.float32)
    kw = dict(top_k=2, capacity_factor=1.0, group_size=8, dispatch=dispatch)
    jy, jaux = jax.jit(lambda p, x: jmoe.moe_apply(p, x, **kw))(jp, jnp.asarray(x))
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    ty, taux = tmoe.moe_apply(tp, torch.from_numpy(x), **kw)
    _close(ty.numpy(), np.asarray(jy))
    np.testing.assert_allclose(float(taux), float(jaux), rtol=RTOL)
    assert float(taux) == pytest.approx(1.0)  # E * sum_e f_e p_e, p_e = 1/E
    _, idx, pos, keep = tmoe.route(torch.full((8, E), 0.25), 2, 4)
    assert torch.equal(idx, torch.tensor([[0, 1]] * 8))
    assert torch.equal(keep, pos < 4) and int(keep.sum()) == 8


@pytest.mark.parametrize("cf", [0.5, 1.25])
def test_gather_dispatch_matches_einsum(cf):
    """The row dispatch computes the one-hot dispatch's function (port of
    ``tests/test_archs.py::test_moe_gather_dispatch_matches_einsum``)."""
    tp = convert.params_from_jax(jax.tree.map(np.asarray, _params(1)),
                                 device="cpu")
    x = torch.from_numpy(
        np.random.default_rng(0).standard_normal((2, 24, D)).astype(np.float32))
    y1, a1 = tmoe.moe_apply(tp, x, top_k=2, capacity_factor=cf, group_size=16,
                            dispatch="einsum")
    y2, a2 = tmoe.moe_apply(tp, x, top_k=2, capacity_factor=cf, group_size=16,
                            dispatch="gather")
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(a1), float(a2), rtol=1e-6)
    with pytest.raises(ValueError, match="unknown moe dispatch"):
        tmoe.moe_apply(tp, x, top_k=2, dispatch="scatter")


def test_init_tree_matches_jax():
    tp = tmoe.moe_init(torch.Generator().manual_seed(0), D, F_, E, "cpu",
                       n_shared=2, shared_d_ff=64)
    jp = _params(1)
    assert [p for p, _ in tree_items(tp)] == [p for p, _ in tree_items(jp)]
    for (path, t), (_, j) in zip(tree_items(tp), tree_items(jp), strict=True):
        assert tuple(t.shape) == tuple(j.shape), path
    assert tmoe.capacity(1024, 6, 1.25, 64) == 120
