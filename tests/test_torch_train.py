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


@pytest.fixture(scope="module")
def jax_run():
    cfg = JaxModelConfig(family="dense", remat=False, **TINY)
    mesh = jax.make_mesh(
        (1, 1), ("data", "model"), axis_types=(AxisType.Auto, AxisType.Auto)
    )
    dist = jd.DistConfig(
        sparsifier=JaxSparsifierConfig(kind="regtopk", sparsity=SPARSITY),
        optimizer=JaxOptConfig(kind="adam", learning_rate=LR),
        dp_axes=("data",),
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


def _close(got, want, msg):
    np.testing.assert_allclose(
        got, want, rtol=RTOL, atol=RTOL * np.abs(want).max(), err_msg=msg
    )


@pytest.mark.parametrize("fastpath", ["off", "on"])
def test_three_train_steps_match_jax(jax_run, fastpath):
    p0, jlosses, jparams, jsp = jax_run
    cfg = ModelConfig(**TINY)
    dist = td.DistConfig(
        sparsifier=SparsifierConfig(kind="regtopk", sparsity=SPARSITY),
        optimizer=OptConfig(kind="adam", learning_rate=LR),
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
        _close(leaf.numpy(), dict(tree_items(jparams))[path], path)
    jstates = dict(tree_items(jsp))
    for path, st in tree_items(sp):
        js = jstates[path]
        np.testing.assert_array_equal(st.t.numpy(), np.asarray(js.t))
        _close(st.eps.numpy(), np.asarray(js.eps).reshape(1, -1), path)
        # the payload lists coordinates by descending score; two scores
        # one ulp apart may list in either order, so compare by index
        order = np.argsort(st.sent_idx.numpy()[0])
        jidx = np.asarray(js.sent_idx).reshape(-1)
        jorder = np.argsort(jidx)
        np.testing.assert_array_equal(
            st.sent_idx.numpy()[0][order], jidx[jorder], err_msg=path
        )
        for name in ("sent_vals", "sent_g"):
            _close(
                getattr(st, name).numpy()[0][order],
                np.asarray(getattr(js, name)).reshape(-1)[jorder],
                f"{path}.{name}",
            )
    if fastpath == "on":
        assert counts.rounds == STEPS * len(tree_items(plan))


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
