"""The port's trainer against the JAX package's, on shared weights and
batches.

* W = 1: three ``train_step``s against ``repro.core.distributed``'s
  ``make_train_step`` on a one-device mesh. The JAX side runs with the
  fastpath off: its fused path equals its dense path bit for bit (the
  JAX package's own tests), and its interpret-mode kernel would take
  about a minute to compile inside the step. The port runs both paths.
  Losses, parameters and the sparsifier state must agree: the set of
  sent indices and the round counters exactly, floats to rtol 1e-5
  (float32 matmuls sum in another order in XLA:CPU and PyTorch) with an
  absolute floor of 1e-5 of each leaf's largest magnitude.
* W = 2: two sparsify-aggregate rounds against the in-process JAX
  composition the runtime performs per worker: ``compact_select`` →
  ``CooFp32`` → ``SparseAllgather.reference`` → ``compact_finalize_sent``.
  The arithmetic is the same there, so aggregate and state must be equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.comm.codec import CooFp32 as JaxCooFp32
from repro.comm.collectives import SparseAllgather as JaxSparseAllgather
from repro.core import compact as jc
from repro.core import distributed as jd
from repro.core.sparsify import SparsifierConfig as JaxSparsifierConfig
from repro.models import get_family
from repro.models.config import ModelConfig as JaxModelConfig
from repro.optim import OptConfig as JaxOptConfig
from repro.optim import make_optimizer as jax_make_optimizer
from repro_torch import convert
from repro_torch.comm.fastpath import FastpathCounts
from repro_torch.core import distributed as td
from repro_torch.core.sparsify import SparsifierConfig
from repro_torch.models.config import ModelConfig
from repro_torch.optim import OptConfig, make_optimizer
from repro_torch.tree import tree_items

RTOL = 1e-5
TINY = dict(name="tiny", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
            head_dim=16, d_ff=128, vocab=256)
SPARSITY, LR, STEPS = 0.01, 1e-3, 3


def _batches(n, B=2, S=16, V=256):
    rng = np.random.default_rng(11)
    return [
        {
            "tokens": rng.integers(0, V, (B, S)).astype(np.int32),
            "labels": rng.integers(0, V, (B, S)).astype(np.int32),
        }
        for _ in range(n)
    ]


def _jax_train(kind="regtopk", selector="exact", collective=None):
    """Three JAX train steps at W = 1; returns (initial params, losses,
    final params, sparsifier state)."""
    cfg = JaxModelConfig(family="dense", remat=False, **TINY)
    mesh = jax.make_mesh(
        (1, 1), ("data", "model"), axis_types=(AxisType.Auto, AxisType.Auto)
    )
    dist = jd.DistConfig(
        sparsifier=JaxSparsifierConfig(
            kind=kind, sparsity=SPARSITY, selector=selector
        ),
        optimizer=JaxOptConfig(kind="adam", learning_rate=LR),
        dp_axes=("data",),
        collective=collective,
    )
    mod = get_family(cfg)
    asm = jd.assemble(mod, cfg, dist, mesh)
    params, _ = mod.init(jax.random.PRNGKey(0), cfg)
    p0 = jax.tree.map(np.asarray, params)
    opt_state = jax_make_optimizer(dist.optimizer).init(params)
    sp, _ = jd.init_sparsifier_state(asm.plan, 1, mesh, ("data",), jnp.float32)
    step = jax.jit(asm.train_step)
    losses = []
    with mesh:
        for b in _batches(STEPS):
            params, opt_state, sp, m = step(
                params, opt_state, sp, jax.tree.map(jnp.asarray, b)
            )
            losses.append(float(m["loss"]))
    return p0, losses, jax.tree.map(np.asarray, params), sp


@pytest.fixture(scope="module")
def jax_run():
    return _jax_train()


def _close(got, want, msg, atol=0.0):
    np.testing.assert_allclose(
        got, want, rtol=RTOL, atol=RTOL * np.abs(want).max() + atol, err_msg=msg
    )


@pytest.mark.parametrize("fastpath", ["off", "on"])
def test_three_train_steps_match_jax(jax_run, fastpath):
    counts, n_leaves = _port_train_matches(
        jax_run, "regtopk", "exact", "sparse_allgather", fastpath
    )
    if fastpath == "on":
        assert counts.rounds == STEPS * n_leaves


@pytest.fixture(scope="module", params=[
    ("cyclic", "exact", "sparse_allgather"),
    ("regtopk", "exact", "dense_allreduce"),
    ("regtopk", "threshold", "sparse_allgather"),
], ids="-".join)
def jax_run_kind(request):
    return request.param, _jax_train(*request.param)


def test_three_train_steps_match_jax_kinds(jax_run_kind):
    """``cyclic``, ``dense_allreduce`` and the threshold selector (through
    ``DistConfig``, as the JAX trainer takes it) against the W = 1 JAX
    train step.

    Cyclic sends coordinates whatever their size, and some accumulated
    gradients cancel to ~1e-6 (the two terms ~2e-3): the gradients' float32
    differences, within the file's tolerance, then shift such a sum by up
    to ~15%, and Adam's eps term turns that into a ~0.1% change of a step
    of size ~lr. Parameters therefore get an absolute floor of ``1e-3 * LR
    * STEPS`` on top of the file's; everything else keeps the file's
    tolerances."""
    (kind, selector, collective), run = jax_run_kind
    _port_train_matches(run, kind, selector, collective, "off",
                        param_atol=1e-3 * LR * STEPS)


def _port_train_matches(jax_run, kind, selector, collective, fastpath,
                        param_atol=0.0):
    p0, jlosses, jparams, jsp = jax_run
    cfg = ModelConfig(**TINY)
    dist = td.DistConfig(
        sparsifier=SparsifierConfig(
            kind=kind, sparsity=SPARSITY, selector=selector
        ),
        optimizer=OptConfig(kind="adam", learning_rate=LR),
        collective=collective,
        fastpath=fastpath,
    )
    params = convert.params_from_jax(p0, device="cpu")
    plan = td.build_plan(params, SPARSITY, dist)
    assert all(p.fused == (fastpath == "on") for _, p in tree_items(plan))
    counts = FastpathCounts()
    step = td.make_train_step(cfg, dist, plan, 1, counts)
    opt_state = make_optimizer(dist.optimizer).init(params)
    sp = td.init_sparsifier_state(plan, 1, "cpu")
    losses = []
    for b in _batches(STEPS):
        tb = {k: torch.from_numpy(v).long() for k, v in b.items()}
        params, opt_state, sp, m = step(params, opt_state, sp, tb)
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses, jlosses, rtol=RTOL)
    for path, leaf in tree_items(params):
        _close(leaf.numpy(), dict(tree_items(jparams))[path], path, param_atol)
    jstates = dict(tree_items(jsp))
    for path, st in tree_items(sp):
        js = jstates[path]
        np.testing.assert_array_equal(st.t.numpy(), np.asarray(js.t))
        _close(st.eps.numpy(), np.asarray(js.eps).reshape(1, -1), path)
        # the payload lists coordinates by descending score; two scores
        # one ulp apart may list in either order, so compare by index
        order = np.argsort(st.sent_idx.numpy()[0], kind="stable")
        jidx = np.asarray(js.sent_idx).reshape(-1)
        jorder = np.argsort(jidx, kind="stable")
        np.testing.assert_array_equal(
            st.sent_idx.numpy()[0][order], jidx[jorder], err_msg=path
        )
        for name in ("sent_vals", "sent_g"):
            _close(
                getattr(st, name).numpy()[0][order],
                np.asarray(getattr(js, name)).reshape(-1)[jorder],
                f"{path}.{name}",
            )
    return counts, len(tree_items(plan))


@pytest.mark.parametrize("fastpath", ["off", "on"])
def test_two_worker_sparsify_aggregate_matches_jax(fastpath):
    W, sparsity = 2, 0.005
    shapes = {"big": (3 * 8192 + 17,), "small": (4, 33)}
    rng = np.random.default_rng(5)
    cfg = SparsifierConfig(kind="regtopk", sparsity=sparsity, mu=1.0)
    dist = td.DistConfig(sparsifier=cfg, fastpath=fastpath)
    plan = td.build_plan(
        {n: torch.zeros(s) for n, s in shapes.items()}, sparsity, dist
    )
    spa = td.make_sparsify_aggregate(plan, dist, W)
    state = td.init_sparsifier_state(plan, W, "cpu")
    jcfg = dataclasses.replace(
        JaxSparsifierConfig(**dataclasses.asdict(cfg)), omega=1.0 / W
    )
    codec, coll = JaxCooFp32(), JaxSparseAllgather()
    jstate = {
        n: [jc.compact_init(plan[n].local_len, plan[n].k) for _ in range(W)]
        for n in shapes
    }
    for _ in range(2):
        grads = {
            n: rng.standard_normal((W, *s)).astype(np.float32)
            for n, s in shapes.items()
        }
        agg, state = spa({n: torch.from_numpy(g) for n, g in grads.items()}, state)
        for n, p in plan.items():
            L, payloads, parts = p.local_len, [], []
            for w in range(W):
                a, v, i = jc.compact_select(
                    jcfg, jstate[n][w], jnp.asarray(grads[n][w].reshape(L)), p.k
                )
                payload = codec.encode(v, i, L)
                dv, di = codec.decode(payload, L)
                payloads.append(payload)
                parts.append((a, dv, di, jnp.zeros(L).at[di].add(dv)))
            stacked = jax.tree.map(lambda *x: jnp.stack(x), *payloads)
            jagg = coll.reference(codec, stacked, 1.0 / W, L)
            np.testing.assert_array_equal(
                agg[n].numpy().reshape(L), np.asarray(jagg)
            )
            for w, (a, dv, di, sent_dense) in enumerate(parts):
                jstate[n][w] = jc.compact_finalize_sent(
                    jstate[n][w], a, dv, di, sent_dense, jagg
                )
                np.testing.assert_array_equal(
                    state[n].sent_idx[w].numpy(), np.asarray(jstate[n][w].sent_idx)
                )
                np.testing.assert_array_equal(
                    state[n].eps[w].numpy(), np.asarray(jstate[n][w].eps)
                )
                np.testing.assert_array_equal(
                    state[n].sent_g[w].numpy(), np.asarray(jstate[n][w].sent_g)
                )


@pytest.mark.parametrize("kind,selector", [
    ("regtopk", "exact"), ("cyclic", "exact"), ("regtopk", "threshold"),
])
def test_two_worker_dense_allreduce_matches_jax(kind, selector):
    """Two ``dense_allreduce`` rounds against the JAX runtime's composition
    per worker: ``compact_select`` → scatter-add into the dense ghat →
    the omega-weighted sum over workers → ``compact_finalize``."""
    W, sparsity = 2, 0.005
    shapes = {"big": (3 * 8192 + 17,), "small": (4, 33)}
    rng = np.random.default_rng(6)
    cfg = SparsifierConfig(kind=kind, sparsity=sparsity, mu=1.0,
                           selector=selector)
    dist = td.DistConfig(sparsifier=cfg, collective="dense_allreduce")
    plan = td.build_plan(
        {n: torch.zeros(s) for n, s in shapes.items()}, sparsity, dist
    )
    spa = td.make_sparsify_aggregate(plan, dist, W)
    state = td.init_sparsifier_state(plan, W, "cpu")
    jcfg = dataclasses.replace(
        JaxSparsifierConfig(**dataclasses.asdict(cfg)), omega=1.0 / W
    )
    jstate = {
        n: [jc.compact_init(plan[n].local_len, plan[n].k) for _ in range(W)]
        for n in shapes
    }
    for _ in range(2):
        grads = {
            n: rng.standard_normal((W, *s)).astype(np.float32)
            for n, s in shapes.items()
        }
        agg, state = spa({n: torch.from_numpy(g) for n, g in grads.items()}, state)
        for n, p in plan.items():
            L, parts = p.local_len, []
            jagg = jnp.zeros(L)
            for w in range(W):
                a, v, i = jc.compact_select(
                    jcfg, jstate[n][w], jnp.asarray(grads[n][w].reshape(L)), p.k
                )
                jagg = jagg + jnp.zeros(L).at[i].add(v) * (1.0 / W)
                parts.append((a, v, i))
            np.testing.assert_array_equal(
                agg[n].numpy().reshape(L), np.asarray(jagg)
            )
            for w, (a, v, i) in enumerate(parts):
                jstate[n][w] = jc.compact_finalize(jstate[n][w], a, v, i, jagg)
                for name in ("sent_idx", "eps", "sent_vals", "sent_g", "t"):
                    np.testing.assert_array_equal(
                        getattr(state[n], name)[w].numpy(),
                        np.asarray(getattr(jstate[n][w], name)), err_msg=name,
                    )


@pytest.mark.parametrize("kind", ["regtopk", "none"])
def test_dense_allreduce_bytes_match_jax(kind):
    """``dense_allreduce`` puts the dense f32 vector on the wire whatever
    the kind, priced as the JAX package's ring all-reduce."""
    from repro.comm import cost

    W = 8
    shapes = {"big": (3 * 8192 + 17,), "small": (4, 33)}
    dist = td.DistConfig(sparsifier=SparsifierConfig(kind=kind, sparsity=0.01),
                         collective="dense_allreduce")
    plan = td.build_plan({n: torch.zeros(s) for n, s in shapes.items()}, 0.01, dist)
    want = sum(
        cost.predicted_bytes("coo_fp32", "dense_allreduce", p.local_len, p.k,
                             (W,), word_bytes=4)
        for p in plan.values()
    )
    assert td.comm_round_bytes(plan, dist, W) == (want, want)


@pytest.mark.parametrize("length,k", [(100, 7), (1_048_576, 10_486)])
def test_measured_payload_bytes_match_jax(length, k):
    """The measured side of ``comm_round_bytes`` counts the buffers one
    encode returns, as the JAX package counts them through
    ``jax.eval_shape``."""
    shapes = jax.eval_shape(
        lambda v, i: JaxCooFp32().encode(v, i, length),
        jax.ShapeDtypeStruct((k,), jnp.float32),
        jax.ShapeDtypeStruct((k,), jnp.int32),
    )
    want = sum(
        int(np.prod(s.shape)) * s.dtype.itemsize
        for s in jax.tree.leaves(shapes)
    )
    assert td._payload_bytes(td.get_codec("coo_fp32"), length, k) == want
