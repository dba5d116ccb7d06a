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
  The arithmetic is the same there, so aggregate and state must be equal;
  so for every codec, for ``hierarchical`` and for coordinate weighting
  (``reference_coord``, the sender mass into ``compact_finalize*``), in
  f32 bits.
* ``DistConfig.microbatches`` (1, 2, 3), ``aggregation`` and
  ``state_dtype="bfloat16"`` against the JAX trainer at W = 1, the
  latter's gate and word sizes against JAX's, and the CLI's
  ``--aggregation`` and ``--microbatches``.
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
import _torch_cores  # noqa: F401  (this worker's share of the cores)

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


def _jax_train(kind="regtopk", selector="exact", collective=None, batch=2,
               **fields):
    """Three JAX train steps at W = 1, ``fields`` (``microbatches``,
    ``state_dtype``, ``aggregation``) set on its ``DistConfig`` and the
    state in ``state_dtype``; returns (initial params, losses, final
    params, sparsifier state)."""
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
        **fields,
    )
    mod = get_family(cfg)
    asm = jd.assemble(mod, cfg, dist, mesh)
    params, _ = mod.init(jax.random.PRNGKey(0), cfg)
    p0 = jax.tree.map(np.asarray, params)
    opt_state = jax_make_optimizer(dist.optimizer).init(params)
    sp, _ = jd.init_sparsifier_state(asm.plan, 1, mesh, ("data",),
                                     jd._DT[dist.state_dtype])
    step = jax.jit(asm.train_step)
    losses = []
    with mesh:
        for b in _batches(STEPS, B=batch):
            params, opt_state, sp, m = step(
                params, opt_state, sp, jax.tree.map(jnp.asarray, b)
            )
            losses.append(float(m["loss"]))
    return p0, losses, jax.tree.map(np.asarray, params), sp


@pytest.fixture(scope="module")
def jax_run():
    return _jax_train()


def _close(got, want, msg, atol=0.0, rtol=RTOL):
    np.testing.assert_allclose(
        got, want, rtol=rtol, atol=rtol * np.abs(want).max() + atol, err_msg=msg
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
                        param_atol=0.0, batch=2, **fields):
    p0, jlosses, jparams, jsp = jax_run
    cfg = ModelConfig(**TINY)
    dist = td.DistConfig(
        sparsifier=SparsifierConfig(
            kind=kind, sparsity=SPARSITY, selector=selector
        ),
        optimizer=OptConfig(kind="adam", learning_rate=LR),
        collective=collective,
        fastpath=fastpath,
        **fields,
    )
    params = convert.params_from_jax(p0, device="cpu")
    plan = td.build_plan(params, SPARSITY, dist)
    assert all(p.fused == (fastpath == "on") for _, p in tree_items(plan))
    counts = FastpathCounts()
    step = td.make_train_step(cfg, dist, plan, 1, counts)
    opt_state = make_optimizer(dist.optimizer).init(params)
    sp = td.init_sparsifier_state(plan, 1, "cpu")
    losses = []
    for b in _batches(STEPS, B=batch):
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


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


@pytest.mark.parametrize("codec,collective,weighting,fastpath", [
    ("coo_idx_delta", "sparse_allgather", "worker", "off"),
    ("coo_idx_delta", "sparse_allgather", "worker", "on"),
    ("bitmap_dense", "sparse_allgather", "worker", "off"),
    ("coo_q8", "sparse_allgather", "worker", "off"),
    ("coo_q8", "sparse_allgather", "worker", "on"),
    ("coo_idx_delta", "hierarchical", "worker", "off"),
    ("coo_fp32", "sparse_allgather", "coordinate", "off"),
    ("coo_q8", "hierarchical", "coordinate", "off"),
    ("coo_fp32", "dense_allreduce", "coordinate", "off"),
])
def test_two_worker_wire_matches_jax(codec, collective, weighting, fastpath):
    """Two rounds of ``make_sparsify_aggregate`` against the JAX package's
    per-worker composition: ``compact_select`` → the codec's encode and
    decode → the collective's ``reference`` or ``reference_coord`` (under
    ``dense_allreduce`` the worker-order sums of the dense vector, and of
    its presence for the sender mass) → ``compact_finalize_sent`` or
    ``compact_finalize`` with ``den``. Aggregates and every state slot in
    f32 bits; ``coo_q8``'s residual stays in ``eps``."""
    from repro.comm import codec as jcodec
    from repro.comm import collectives as jcoll

    W, sparsity = 2, 0.005
    shapes = {"big": (3 * 8192 + 17,), "small": (4, 33)}
    rng = np.random.default_rng(9)
    cfg = SparsifierConfig(kind="regtopk", sparsity=sparsity, mu=1.0)
    dist = td.DistConfig(sparsifier=cfg, codec=codec, collective=collective,
                         weighting=weighting, fastpath=fastpath)
    plan = td.build_plan(
        {n: torch.zeros(s) for n, s in shapes.items()}, sparsity, dist
    )
    assert plan["big"].fused == (fastpath == "on")
    spa = td.make_sparsify_aggregate(plan, dist, W)
    state = td.init_sparsifier_state(plan, W, "cpu")
    jcfg = dataclasses.replace(
        JaxSparsifierConfig(**dataclasses.asdict(cfg)), omega=1.0 / W
    )
    jcd, coll = jcodec.get_codec(codec), jcoll.get_collective(collective)
    coord = weighting == "coordinate"
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
                payload = jcd.encode(v, i, L)
                dv, di = jcd.decode(payload, L)
                payloads.append(payload)
                parts.append((a, v, i, dv, di))
            den = None
            if collective == "dense_allreduce":
                jagg = den = jnp.zeros(L)
                for a, v, i, _, _ in parts:
                    ghat = jnp.zeros(L).at[i].add(v)
                    jagg = jagg + ghat * (1.0 / W)
                    den = den + (ghat != 0).astype(ghat.dtype) * (1.0 / W)
                jagg = jagg / jnp.maximum(den, jnp.finfo(den.dtype).tiny)
            else:
                stacked = jax.tree.map(lambda *x: jnp.stack(x), *payloads)
                if coord:
                    jagg, den = coll.reference_coord(jcd, stacked, 1.0 / W, L)
                else:
                    jagg = coll.reference(jcd, stacked, 1.0 / W, L)
            np.testing.assert_array_equal(
                _bits(agg[n].numpy().reshape(L)), _bits(jagg), err_msg=n)
            for w, (a, v, i, dv, di) in enumerate(parts):
                if collective == "dense_allreduce":
                    jstate[n][w] = jc.compact_finalize(
                        jstate[n][w], a, v, i, jagg, den=den)
                else:
                    jstate[n][w] = jc.compact_finalize_sent(
                        jstate[n][w], a, dv, di, jnp.zeros(L).at[di].add(dv),
                        jagg, den=den)
                for name in ("eps", "sent_vals", "sent_g", "sent_w"):
                    np.testing.assert_array_equal(
                        _bits(getattr(state[n], name)[w].numpy()),
                        _bits(getattr(jstate[n][w], name)), err_msg=f"{n}.{name}")
                np.testing.assert_array_equal(
                    state[n].sent_idx[w].numpy(), np.asarray(jstate[n][w].sent_idx))
    if coord:
        assert not bool((state["big"].sent_w == 1.0).all())


@pytest.mark.parametrize("codec", ["coo_idx_delta", "bitmap_dense", "coo_q8"])
def test_comm_round_bytes_and_cost_match_jax(codec):
    """``comm_round_bytes`` and ``comm_round_cost`` from ``comm/cost.py``,
    against the JAX package's on the same plan (one dp axis of W = 8,
    a scalar and a per-axis link model)."""
    from jax.sharding import PartitionSpec as P

    from repro.comm import cost as jcost
    from repro_torch.comm import cost as tcost

    class _Mesh:
        shape = {"data": 8}

    shapes = {"big": (3 * 8192 + 17,), "small": (4, 33)}
    for coll in ("sparse_allgather", "hierarchical", "dense_allreduce"):
        for topo in (None, "2e-6,5e-12"):
            dist = td.DistConfig(
                sparsifier=SparsifierConfig(kind="regtopk", sparsity=0.01),
                codec=codec, collective=coll,
                link_topo=None if topo is None else tcost.parse_link_topo(topo, ("data",)))
            plan = td.build_plan({n: torch.zeros(s) for n, s in shapes.items()}, 0.01, dist)
            jdist = jd.DistConfig(
                sparsifier=JaxSparsifierConfig(kind="regtopk", sparsity=0.01),
                codec=codec, collective=coll,
                link_topo=None if topo is None else jcost.parse_link_topo(topo, ("data",)))
            jplan = {n: jd.LeafPlan(s, s, p.local_len, p.k, P(None))
                     for (n, s), p in zip(shapes.items(), plan.values(), strict=True)}
            assert td.comm_round_bytes(plan, dist, 8) == jd.comm_round_bytes(
                jplan, jdist, _Mesh())
            got, want = td.comm_round_cost(plan, dist, 8), jd.comm_round_cost(
                jplan, jdist, _Mesh())
            assert (got.bytes_on_wire, got.n_messages, got.seconds) == (
                want.bytes_on_wire, want.n_messages, want.seconds)


@pytest.mark.parametrize("flags", [
    ["--codec", "coo_q8", "--fastpath", "on"],
    ["--codec", "bitmap_dense", "--fastpath", "on"],
    ["--codec", "coo_idx_delta", "--coord-weights", "--fastpath", "auto",
     "--link-topo", "data:2e-6,5e-12"],
    ["--collective", "hierarchical", "--coord-weights"],
])
def test_cli_takes_the_wire_flags(flags, capsys):
    """The trainer's wire flags, two smoke steps on the CPU: the comm line
    in the JAX trainer's format, the fastpath line, finite losses."""
    from repro_torch.launch import train

    args = train.parse_args(["--smoke", "--workers", "2", "--steps", "2",
                             "--seq", "16", "--device", "cpu", *flags])
    res = train.run(args)
    out = capsys.readouterr().out
    assert all(np.isfinite(res.losses)) and len(res.losses) == 2
    assert "MB/worker/round (predicted " in out
    assert "ms/round under the link model)" in out
    if "on" in flags:
        assert "comm:   fastpath:" in out
        assert (res.counts.rounds > 0) == ("coo_q8" in flags)
    if "--coord-weights" in flags:
        assert "weighting: coordinate" in out
        assert res.counts.rounds == 0
    if "--link-topo" in flags:
        assert "link-topo data: alpha=2.000e-06 s/msg beta=5.000e-12 s/B" in out


# ---------------------------------------------------------------------------
# partial participation and the adaptive-k controller
# ---------------------------------------------------------------------------
ADAPTIVE_SPEC = "1.0,0.001,0.02"


def _adaptive(mod):
    return mod.parse_adaptive_k(ADAPTIVE_SPEC)


def _jax_adaptive_train():
    """The JAX trainer at W = 1 (Auto mesh) with ``--adaptive-k``: (initial
    params, losses, per-step k metric, final params, (state, controller))."""
    from repro.comm import controller as jctl

    cfg = JaxModelConfig(family="dense", remat=False, **TINY)
    mesh = jax.make_mesh(
        (1, 1), ("data", "model"), axis_types=(AxisType.Auto, AxisType.Auto)
    )
    dist = jd.DistConfig(
        sparsifier=JaxSparsifierConfig(kind="regtopk", sparsity=SPARSITY),
        optimizer=JaxOptConfig(kind="adam", learning_rate=LR),
        dp_axes=("data",), adaptive_k=_adaptive(jctl),
    )
    mod = get_family(cfg)
    asm = jd.assemble(mod, cfg, dist, mesh)
    params, _ = mod.init(jax.random.PRNGKey(0), cfg)
    p0 = jax.tree.map(np.asarray, params)
    opt_state = jax_make_optimizer(dist.optimizer).init(params)
    sp, _ = jd.init_sparsifier_state(asm.plan, 1, mesh, ("data",), jnp.float32)
    sp = (sp, jd.init_controller_state(asm.plan, dist)[0])
    step = jax.jit(asm.train_step)
    losses, ks = [], []
    with mesh:
        for b in _batches(STEPS):
            params, opt_state, sp, m = step(
                params, opt_state, sp, jax.tree.map(jnp.asarray, b)
            )
            losses.append(float(m["loss"]))
            ks.append((float(m["adaptive_k"]), [int(c.k) for c in _ctrl_leaves(sp[1])]))
    return p0, losses, ks, jax.tree.map(np.asarray, params), sp


def _ctrl_leaves(ctrl):
    """A JAX controller tree's ``ControllerState``s in sorted-key order,
    the order of the port's ``tree_items``."""
    from repro.comm.controller import ControllerState

    return jax.tree.leaves(ctrl, is_leaf=lambda x: isinstance(x, ControllerState))


@pytest.mark.parametrize("fastpath", ["off", "on"])
def test_adaptive_k_train_steps_match_jax(fastpath):
    """Three steps under ``--adaptive-k`` against the JAX trainer at W = 1:
    losses and params to the file's tolerances, every leaf's controller k
    after every step exactly, ``err_ratio`` to rtol 1e-5, each leaf's
    capacity its k_max bound; the fused leaves keep the kernel."""
    from repro_torch.comm import controller as tctl

    p0, jlosses, jks, jparams, (jsp, jctrl) = _jax_adaptive_train()
    cfg = ModelConfig(**TINY)
    dist = td.DistConfig(
        sparsifier=SparsifierConfig(kind="regtopk", sparsity=SPARSITY),
        optimizer=OptConfig(kind="adam", learning_rate=LR),
        fastpath=fastpath, adaptive_k=_adaptive(tctl),
    )
    params = convert.params_from_jax(p0, device="cpu")
    plan = td.build_plan(params, SPARSITY, dist)
    counts = FastpathCounts()
    step = td.make_train_step(cfg, dist, plan, 1, counts)
    opt_state = make_optimizer(dist.optimizer).init(params)
    sp = (td.init_sparsifier_state(plan, 1, "cpu"),
          td.init_controller_state(plan, dist, "cpu"))
    losses, ks = [], []
    for b in _batches(STEPS):
        tb = {k: torch.from_numpy(v).long() for k, v in b.items()}
        params, opt_state, sp, m = step(params, opt_state, sp, tb)
        losses.append(float(m["loss"]))
        ks.append((float(m["adaptive_k"]), [int(c.k) for _, c in tree_items(sp[1])]))
    np.testing.assert_allclose(losses, jlosses, rtol=RTOL)
    # every leaf's k, step by step, exactly; the mean over leaves to the
    # last bits (XLA:CPU divides by the leaf count as a reciprocal product)
    assert [k for _, k in ks] == [k for _, k in jks]
    np.testing.assert_allclose([m for m, _ in ks], [m for m, _ in jks], rtol=1e-6)
    assert len({m for m, _ in ks}) > 1  # the controller moved k
    for path, leaf in tree_items(params):
        _close(leaf.numpy(), dict(tree_items(jparams))[path], path)
    for (path, c), jcs in zip(tree_items(sp[1]), _ctrl_leaves(jctrl), strict=True):
        assert int(c.k) == int(jcs.k) and int(c.t) == int(jcs.t) == STEPS, path
        np.testing.assert_allclose(float(c.err_ratio), float(jcs.err_ratio),
                                   rtol=1e-5, err_msg=path)
    for path, p in tree_items(plan):
        assert p.k == dist.adaptive_k.bounds(p.local_len)[1]
    if fastpath == "on":
        assert counts.rounds == STEPS * sum(p.fused for _, p in tree_items(plan)) > 0


def _batches_w(n, W):
    """``n`` global batches of W rows (one per worker), from numpy."""
    rng = np.random.default_rng(13)
    return [{key: rng.integers(0, TINY["vocab"], (W, 16)).astype(np.int32)
             for key in ("tokens", "labels")} for _ in range(n)]


def _jax_composed_train(W, participation=None, adaptive=None, dist=None,
                        cfg=None, batches=None):
    """The JAX trainer's step at W workers in this one-device process: the
    JAX model's per-worker ``value_and_grad`` under ``jax.vmap``, the
    runtime's own per-worker round (``_spa_leaf``, with the round's
    participation context and the controller's k, and ``_ctrl_update``)
    under ``jax.vmap(axis_name="data")``, as ``make_sparsify_aggregate``
    runs them under ``shard_map``, and its Adam. ``dist`` (a JAX
    ``DistConfig``, e.g. with ``codec``/``collective="auto"``) plans the
    leaves with ``build_plan`` on a W-worker dp axis, each leaf then on
    its own wire (``leaf_wire``); None is ``coo_fp32`` +
    ``sparse_allgather``. ``cfg`` (a JAX ``ModelConfig``; None is
    ``TINY``) and ``batches`` (global batches of numpy arrays, one row per
    worker; None is ``_batches_w``) set the model and its data. Returns
    (initial params, losses, per-step leaf ks, final params, final state,
    final controller), and the plan when ``dist`` is given."""
    from jax.sharding import PartitionSpec as P

    from repro.comm import worker_index

    cfg = cfg or JaxModelConfig(family="dense", remat=False, **TINY)
    mod = get_family(cfg)
    params, _ = mod.init(jax.random.PRNGKey(0), cfg)
    p0 = jax.tree.map(np.asarray, params)
    opt = jax_make_optimizer(JaxOptConfig(kind="adam", learning_rate=LR))
    opt_state = opt.init(params)
    omega = 1.0 / W if participation is None else participation.effective_omega(W)
    scfg = JaxSparsifierConfig(kind="regtopk", sparsity=SPARSITY, omega=omega)

    def k_of(n):
        return (adaptive.bounds(n)[1] if adaptive is not None
                else jd.sparsity_to_k(n, SPARSITY))

    if dist is None:
        plan = jax.tree.map(lambda x: jd.LeafPlan(
            x.shape, x.shape, int(np.prod(x.shape)), k_of(int(np.prod(x.shape))),
            P(None)), params)
        wire_dist = jd.DistConfig(codec="coo_fp32", collective="sparse_allgather")
    else:
        class _Mesh:
            shape = {"data": W}

        plan = jd.build_plan(params, jax.tree.map(lambda _: P(), params), _Mesh(),
                             SPARSITY, dist)
        wire_dist = dist
    is_plan = jd._is_plan

    def init_state(p):
        st = jc.compact_init(p.local_len, p.k)
        one = jc.CompactState(
            eps=st.eps.reshape((1,) + p.local_shape),
            sent_vals=st.sent_vals[None, None], sent_g=st.sent_g[None, None],
            sent_idx=st.sent_idx[None, None], sent_w=st.sent_w[None, None],
            t=st.t[None])
        return jax.tree.map(lambda x: jnp.stack([x] * W), one)

    state = jax.tree.map(init_state, plan, is_leaf=is_plan)
    ctrl = None
    if adaptive is not None:
        ctrl = jax.tree.map(lambda p: adaptive.init(
            jd.sparsity_to_k(p.local_len, SPARSITY), *adaptive.bounds(p.local_len)),
            plan, is_leaf=is_plan)

    def rounds(grads, st, ct):
        flat_p, tdef = jax.tree.flatten(plan, is_leaf=is_plan)
        flat_g, flat_s = tdef.flatten_up_to(grads), tdef.flatten_up_to(st)
        flat_c = tdef.flatten_up_to(ct) if ct is not None else [None] * len(flat_p)
        part_ctx = None
        if participation is not None:
            pmask = participation.round_mask(flat_s[0].t[0], W)
            m = pmask[worker_index(("data",), (W,))]
            part_ctx = (m, 1.0 / jnp.maximum(pmask.sum(), 1.0))
        wires = [jd.leaf_wire(p, wire_dist) for p in flat_p]
        outs = [jd._spa_leaf(g, s, p, scfg, jd.comm.get_codec(cname), coll,
                             ("data",), part_ctx, False,
                             None if c is None else c.k)
                for g, s, p, c, (cname, coll) in zip(
                    flat_g, flat_s, flat_p, flat_c, wires, strict=True)]
        agg = tdef.unflatten([o[0] for o in outs])
        new = tdef.unflatten([o[1] for o in outs])
        if ct is None:
            return agg, new, None
        new_c = tdef.unflatten([
            jd._ctrl_update(adaptive, c, o[1], o[0], p, ("data",), (),
                            *adaptive.bounds(p.local_len))
            for o, c, p in zip(outs, flat_c, flat_p, strict=True)])
        return agg, new, new_c

    def train_step(params, opt_state, st, ct, batch):
        wb = jax.tree.map(lambda x: x.reshape((W, 1) + x.shape[1:]), batch)
        losses, grads = jax.vmap(jax.value_and_grad(
            lambda p, b: mod.loss_fn(p, cfg, b)[0]), in_axes=(None, 0))(params, wb)
        grads = jax.tree.map(lambda g: g[:, None], grads)
        agg, new, new_c = jax.vmap(rounds, axis_name="data",
                                   in_axes=(0, 0, None))(grads, st, ct)
        agg = jax.tree.map(lambda x: x[0], agg)
        new_c = None if new_c is None else jax.tree.map(lambda x: x[0], new_c)
        new_params, new_opt = opt.update(agg, opt_state, params)
        return new_params, new_opt, new, new_c, losses.mean()

    step = jax.jit(train_step)
    losses, ks = [], []
    for b in batches or _batches_w(STEPS, W):
        params, opt_state, state, ctrl, loss = step(
            params, opt_state, state, ctrl, jax.tree.map(jnp.asarray, b))
        losses.append(float(loss))
        if ctrl is not None:
            ks.append([int(c.k) for c in _ctrl_leaves(ctrl)])
    out = (p0, losses, ks, jax.tree.map(np.asarray, params), state, ctrl)
    return out if dist is None else (*out, plan)


COMPOSED = {
    "round_robin": ("round_robin:2", None),
    "adaptive": (None, ADAPTIVE_SPEC),
    "round_robin-adaptive": ("round_robin:2", ADAPTIVE_SPEC),
}


@pytest.mark.parametrize("case", list(COMPOSED))
def test_partial_and_adaptive_train_steps_match_jax_at_four_workers(case):
    """``--participation round_robin:2`` and ``--adaptive-k`` on one card
    with W = 4, three steps against the JAX step at W = 4
    (``_jax_composed_train``): losses and params to the file's tolerances,
    every worker's round counter exactly, its error to rtol 1e-5 with the
    file's floor, the sent sets by index, and every leaf's k exactly."""
    from repro.comm import controller as jctl
    from repro.comm import participation as jpart
    from repro_torch.comm import controller as tctl
    from repro_torch.comm import participation as tpart

    W = 4
    pspec, aspec = COMPOSED[case]
    p0, jlosses, jks, jparams, jstate, jctrl = _jax_composed_train(
        W, pspec and jpart.parse_participation(pspec),
        aspec and jctl.parse_adaptive_k(aspec))
    cfg = ModelConfig(**TINY)
    dist = td.DistConfig(
        sparsifier=SparsifierConfig(kind="regtopk", sparsity=SPARSITY),
        optimizer=OptConfig(kind="adam", learning_rate=LR),
        participation=pspec and tpart.parse_participation(pspec),
        adaptive_k=aspec and tctl.parse_adaptive_k(aspec),
    )
    params = convert.params_from_jax(p0, device="cpu")
    plan = td.build_plan(params, SPARSITY, dist)
    step = td.make_train_step(cfg, dist, plan, W)
    opt_state = make_optimizer(dist.optimizer).init(params)
    sp = td.init_sparsifier_state(plan, W, "cpu")
    if aspec:
        sp = (sp, td.init_controller_state(plan, dist, "cpu"))
    losses, ks = [], []
    for b in _batches_w(STEPS, W):
        tb = {k: torch.from_numpy(v).long() for k, v in b.items()}
        params, opt_state, sp, m = step(params, opt_state, sp, tb)
        losses.append(float(m["loss"]))
        if aspec:
            ks.append([int(c.k) for _, c in tree_items(sp[1])])
    np.testing.assert_allclose(losses, jlosses, rtol=RTOL)
    assert ks == jks
    if aspec:
        assert len({tuple(k) for k in ks}) > 1
    for path, leaf in tree_items(params):
        _close(leaf.numpy(), dict(tree_items(jparams))[path], path)
    cstate = sp[0] if aspec else sp
    jflat = jax.tree.leaves(jstate, is_leaf=lambda x: isinstance(x, jc.CompactState))
    for (path, st), js in zip(tree_items(cstate), jflat, strict=True):
        np.testing.assert_array_equal(st.t.numpy(), np.asarray(js.t).reshape(W))
        _close(st.eps.numpy(), np.asarray(js.eps).reshape(W, -1), path)
        jidx = np.asarray(js.sent_idx).reshape(W, -1)
        for w in range(W):
            np.testing.assert_array_equal(np.sort(st.sent_idx.numpy()[w]),
                                          np.sort(jidx[w]), err_msg=f"{path} w{w}")


@pytest.mark.parametrize("flags", [
    ["--workers", "4", "--participation", "round_robin:2"],
    ["--workers", "4", "--participation", "bernoulli:0.25", "--fastpath", "on"],
    ["--workers", "2", "--adaptive-k", ADAPTIVE_SPEC, "--fastpath", "on"],
    ["--workers", "4", "--participation", "sampled:2,5", "--adaptive-k", "0.5",
     "--collective", "dense_allreduce"],
])
def test_cli_takes_participation_and_adaptive_k(flags, capsys):
    """``--participation`` and ``--adaptive-k``, two smoke steps on the CPU:
    the JAX trainer's printed lines, the per-step k column, finite losses,
    and partial rounds priced below the full round's measured bytes."""
    import re

    from repro_torch.launch import train

    args = train.parse_args(["--smoke", "--steps", "2", "--seq", "16",
                             "--device", "cpu", "--log-every", "1", *flags])
    res = train.run(args)
    out = capsys.readouterr().out
    assert all(np.isfinite(res.losses)) and len(res.losses) == 2
    pred, meas = (float(x) for x in re.search(
        r"([\d.]+) MB/worker/round \(predicted ([\d.]+) MB", out).groups()[::-1])
    if "--participation" in flags:
        kind = flags[flags.index("--participation") + 1].split(":")[0]
        assert re.search(rf"participation: {kind} — expected [\d.]+/4 workers on "
                         r"time per round \(renormalized weights\)", out)
        assert pred < meas
    if "--adaptive-k" in flags:
        assert "adaptive-k: budget=" in out and "momentum=0.9 hysteresis=0.25" in out
        assert len(re.findall(r"^step +\d+ loss \S+ k +[\d.]+ \(", out, re.M)) == 2
        assert isinstance(res.sp_state, tuple)
    if "on" in flags:
        assert res.counts.rounds > 0


def test_cli_refuses_stale_as_jax():
    """``stale`` needs the simulator's pending buffer: the trainer refuses
    it as the JAX trainer does; an unrealizable schedule fails at start."""
    from repro_torch.launch import train

    base = ["--smoke", "--steps", "1", "--seq", "16", "--device", "cpu"]
    with pytest.raises(ValueError, match="simulator-only"):
        train.run(train.parse_args([*base, "--workers", "4",
                                    "--participation", "stale:1,2,0.5"]))
    with pytest.raises(ValueError, match="would drop every one"):
        train.run(train.parse_args([*base, "--workers", "2",
                                    "--participation", "round_robin:2"]))
    with pytest.raises(ValueError, match="bad --participation spec"):
        train.run(train.parse_args([*base, "--participation", "bogus"]))


@pytest.mark.parametrize("spec", ["round_robin:2", "bernoulli:0.25", "sampled:3"])
def test_comm_round_bytes_price_partial_rounds_as_jax(spec):
    """Partial rounds priced as the JAX package prices them: the predicted
    bytes and cost at the expected participants, the measured bytes the
    full round's; under adaptive k at each leaf's k_max capacity."""
    from jax.sharding import PartitionSpec as P

    from repro.comm import controller as jctl
    from repro.comm import participation as jpart
    from repro_torch.comm import controller as tctl
    from repro_torch.comm import participation as tpart

    class _Mesh:
        shape = {"data": 8}

    shapes = {"big": (3 * 8192 + 17,), "small": (4, 33)}
    for coll in ("sparse_allgather", "hierarchical", "dense_allreduce"):
        for adaptive in (None, "0.5,2,0.05"):
            dist = td.DistConfig(
                sparsifier=SparsifierConfig(kind="regtopk", sparsity=0.01),
                collective=coll, participation=tpart.parse_participation(spec),
                adaptive_k=adaptive and tctl.parse_adaptive_k(adaptive))
            jdist = jd.DistConfig(
                sparsifier=JaxSparsifierConfig(kind="regtopk", sparsity=0.01),
                collective=coll, participation=jpart.parse_participation(spec),
                adaptive_k=adaptive and jctl.parse_adaptive_k(adaptive))
            plan = td.build_plan({n: torch.zeros(s) for n, s in shapes.items()},
                                 0.01, dist)
            jplan = {n: jd.LeafPlan(s, s, p.local_len, p.k, P(None))
                     for (n, s), p in zip(shapes.items(), plan.values(), strict=True)}
            if adaptive:
                assert all(p.k == dist.adaptive_k.bounds(p.local_len)[1]
                           for p in plan.values())
            got, want = td.comm_round_bytes(plan, dist, 8), jd.comm_round_bytes(
                jplan, jdist, _Mesh())
            assert got == want and got[0] < got[1]
            gc, wc = td.comm_round_cost(plan, dist, 8), jd.comm_round_cost(
                jplan, jdist, _Mesh())
            assert (gc.bytes_on_wire, gc.n_messages, gc.seconds) == (
                wc.bytes_on_wire, wc.n_messages, wc.seconds)


# ---------------------------------------------------------------------------
# DistConfig.microbatches, state_dtype and aggregation
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=[1, 2, 3], ids=lambda n: f"mb{n}")
def jax_mb_run(request):
    return request.param, _jax_train(microbatches=request.param, batch=6)


@pytest.mark.parametrize("fastpath", ["off", "on"])
def test_microbatches_match_jax(jax_mb_run, fastpath):
    """``microbatches`` 1, 2 and 3 against the JAX trainer at W = 1 on a
    batch of 6 rows: each worker's shard splits into contiguous chunks in
    order, the loss accumulates in f32 and the gradient in the state
    dtype, each term ``x * fl(1/n)`` as the jitted JAX scan adds ``x /
    n``. The file's tolerances."""
    n_mb, run = jax_mb_run
    _port_train_matches(run, "regtopk", "exact", None, fastpath, batch=6,
                        microbatches=n_mb)


def test_microbatches_refuse_a_shard_that_does_not_split():
    from repro_torch.models import lm

    cfg = ModelConfig(**TINY)
    dist = td.DistConfig(microbatches=4)
    params = lm.init(cfg, seed=0, device="cpu")
    plan = td.build_plan(params, SPARSITY, dist)
    step = td.make_train_step(cfg, dist, plan, 1)
    b = {k: torch.from_numpy(v).long() for k, v in _batches(1, B=6)[0].items()}
    with pytest.raises(ValueError, match="does not split into 4 microbatches"):
        step(params, make_optimizer(dist.optimizer).init(params),
             td.init_sparsifier_state(plan, 1, "cpu"), b)
    with pytest.raises(ValueError, match="microbatches must be >= 1"):
        td.make_train_step(cfg, td.DistConfig(microbatches=0), plan, 1)


@pytest.mark.parametrize("collective", [None, "dense_allreduce"])
def test_bf16_state_steps_match_jax(collective):
    """``state_dtype="bfloat16"``: three steps against the JAX trainer at
    W = 1 with its state in bf16 (eps and the ``sent_*`` slots), the
    gradient cast to bf16 and scored in bf16 unfused.

    The model's f32 gradients differ between the stacks in their last bits
    (the file's tolerance), and a bf16 cast turns such a difference into a
    whole bf16 step where a value sits at a rounding boundary: a handful
    of ``eps`` elements differ by one bf16 step, and once in a while two
    near-equal bf16 scores trade places in the top-k. Pinned here as a
    boundary effect: losses to the file's rtol; round counters exactly;
    each leaf's sent set equal but for at most 2% of its k; params and
    ``eps`` to the file's tolerance (``eps`` to one bf16 step, rtol 1e-2)
    in all but 0.1% of the elements, those by at most 2 lr a step. The
    score chain and the bf16 top-k on equal inputs are held in bits by
    ``test_torch_compact.py``."""
    p0, jlosses, jparams, jsp = _jax_train(collective=collective,
                                           state_dtype="bfloat16")
    cfg = ModelConfig(**TINY)
    dist = td.DistConfig(
        sparsifier=SparsifierConfig(kind="regtopk", sparsity=SPARSITY),
        optimizer=OptConfig(kind="adam", learning_rate=LR),
        collective=collective, state_dtype="bfloat16")
    params = convert.params_from_jax(p0, device="cpu")
    plan = td.build_plan(params, SPARSITY, dist)
    step = td.make_train_step(cfg, dist, plan, 1)
    opt_state = make_optimizer(dist.optimizer).init(params)
    sp = td.init_sparsifier_state(plan, 1, "cpu", torch.bfloat16)
    losses = []
    for b in _batches(STEPS):
        tb = {k: torch.from_numpy(v).long() for k, v in b.items()}
        params, opt_state, sp, m = step(params, opt_state, sp, tb)
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses, jlosses, rtol=RTOL)

    def mostly_close(got, want, rtol, msg):
        beyond = np.abs(got - want) > rtol * np.abs(want) + rtol * np.abs(want).max()
        assert beyond.sum() <= max(1, 1e-3 * want.size), msg
        assert np.abs(got - want)[beyond].max(initial=0) <= 2 * LR * STEPS, msg

    jp = dict(tree_items(jparams))
    for path, leaf in tree_items(params):
        mostly_close(leaf.numpy(), jp[path], RTOL, path)
    js = dict(tree_items(jsp))
    for path, st in tree_items(sp):
        assert st.eps.dtype == st.sent_vals.dtype == torch.bfloat16, path
        np.testing.assert_array_equal(st.t.numpy(), np.asarray(js[path].t))
        got = set(st.sent_idx[0].tolist())
        want = set(np.asarray(js[path].sent_idx).reshape(-1).tolist())
        # each trade of places puts one index in either set only
        traded = sorted(got ^ want)
        assert len(traded) <= 2 * max(1, int(0.02 * len(want))), path
        # a traded coordinate holds its accumulated value on one side, 0
        # on the other
        keep = np.ones(st.eps.numel(), bool)
        keep[traded] = False
        mostly_close(st.eps.float().numpy().reshape(-1)[keep],
                     np.asarray(js[path].eps, np.float32).reshape(-1)[keep], 1e-2,
                     path)


def test_bf16_state_gates_the_fastpath_as_jax():
    """The JAX gate: ``on`` raises with JAX's message, ``auto`` resolves to
    ``off``, so no leaf fuses; an unknown dtype raises."""
    for fields in (dict(), dict(weighting="coordinate")):
        jon = jd.DistConfig(state_dtype="bfloat16", fastpath="on", **fields)
        ton = td.DistConfig(state_dtype="bfloat16", fastpath="on", **fields)
        with pytest.raises(ValueError) as want:
            jon.resolved_fastpath()
        with pytest.raises(ValueError) as got:
            ton.resolved_fastpath()
        assert str(got.value) == str(want.value)
    auto = td.DistConfig(state_dtype="bfloat16", fastpath="auto")
    assert auto.resolved_fastpath() == "off"
    assert jd.DistConfig(state_dtype="bfloat16", fastpath="auto").resolved_fastpath() == "off"
    plan = td.build_plan({"w": torch.zeros(3 * 8192)}, 0.01, auto)
    assert not plan["w"].fused
    with pytest.raises(ValueError, match="unknown state_dtype"):
        td.DistConfig(state_dtype="float16").resolved_state_dtype()


@pytest.mark.parametrize("kind", ["regtopk", "none"])
@pytest.mark.parametrize("codec,collective", [
    ("coo_fp32", "dense_allreduce"), ("coo_idx_delta", "sparse_allgather"),
    ("auto", "auto"),
])
def test_bf16_state_bytes_and_plan_match_jax(kind, codec, collective):
    """The word size follows the state dtype as in JAX: ``dense_allreduce``
    moves bf16 words (kind ``none`` keeps f32, its mean is taken in f32),
    payload collectives keep 4-byte dense terms, and ``build_plan``'s auto
    branch prices the dense candidate at 2 bytes a word: the per-leaf
    picks, ``comm_round_bytes`` and ``comm_round_cost`` equal JAX's."""
    from jax.sharding import PartitionSpec as P

    class _Mesh:
        shape = {"data": 8}

    shapes = {"big": (3 * 8192 + 17,), "small": (4, 33), "mid": (4096,)}
    for state_dtype in ("float32", "bfloat16"):
        kw = dict(codec=codec, collective=collective, state_dtype=state_dtype)
        dist = td.DistConfig(sparsifier=SparsifierConfig(kind=kind, sparsity=0.01), **kw)
        jdist = jd.DistConfig(sparsifier=JaxSparsifierConfig(kind=kind, sparsity=0.01),
                              **kw)
        plan = td.build_plan({n: torch.zeros(s) for n, s in shapes.items()}, 0.01,
                             dist, workers=8)
        jplan = jd.build_plan({n: jax.ShapeDtypeStruct(s, jnp.float32)
                               for n, s in shapes.items()},
                              {n: P(None) for n in shapes}, _Mesh(), 0.01, jdist)
        for n in shapes:
            assert td.leaf_wire(plan[n], dist) == jd.leaf_wire(jplan[n], jdist), n
        assert td.comm_round_bytes(plan, dist, 8) == jd.comm_round_bytes(
            jplan, jdist, _Mesh())
        got, want = td.comm_round_cost(plan, dist, 8), jd.comm_round_cost(
            jplan, jdist, _Mesh())
        assert (got.bytes_on_wire, got.n_messages, got.seconds) == (
            want.bytes_on_wire, want.n_messages, want.seconds)


def test_bf16_state_through_the_cli(capsys):
    """``state_dtype`` has no flag, as in JAX: ``run(args, dist=...)``
    takes it; the state is bf16, the comm line prices bf16 words under
    ``dense_allreduce``, and ``--fastpath on`` raises JAX's error."""
    import dataclasses

    from repro_torch.launch import train

    args = train.parse_args(["--smoke", "--workers", "2", "--steps", "2", "--seq",
                             "16", "--device", "cpu", "--collective",
                             "dense_allreduce"])
    dist = dataclasses.replace(train.dist_config(args), state_dtype="bfloat16")
    res = train.run(args, dist=dist)
    out = capsys.readouterr().out
    assert all(np.isfinite(res.losses))
    assert all(st.eps.dtype == torch.bfloat16 for _, st in tree_items(res.sp_state))
    f32_bytes = td.comm_round_bytes(res.plan, train.dist_config(args), 2)[1]
    bf16_bytes = td.comm_round_bytes(res.plan, dist, 2)[1]
    assert 2 * bf16_bytes == f32_bytes
    assert f"{bf16_bytes / 1e6:.3f} MB/worker/round" in out
    with pytest.raises(ValueError, match="requires state_dtype='float32'"):
        train.run(args, dist=dataclasses.replace(dist, fastpath="on"))


@pytest.mark.parametrize("aggregation,collective", [
    ("dense_allreduce", None), ("sparse_allgather", "dense_allreduce"),
    ("hierarchical", None), ("auto", None),
])
def test_aggregation_resolves_as_jax(aggregation, collective):
    """``aggregation`` is the collective where ``collective`` is None, as
    ``resolved_collective`` in JAX; ``aggregation="auto"`` does not plan
    (JAX's ``build_plan`` reads ``collective``) and so raises at the
    leaf's wire, as in JAX."""
    kw = dict(aggregation=aggregation, collective=collective)
    dist, jdist = td.DistConfig(**kw), jd.DistConfig(**kw)
    assert dist.resolved_collective() == jdist.resolved_collective()
    plan = td.build_plan({"w": torch.zeros(100)}, 0.05, dist, workers=2)
    if jdist.resolved_collective() == "auto":
        with pytest.raises(ValueError, match="requires a plan built"):
            td.leaf_wire(plan["w"], dist)
    else:
        assert td.leaf_wire(plan["w"], dist)[1] == jdist.resolved_collective()


def test_aggregation_steps_match_jax():
    """``aggregation="dense_allreduce"`` with no collective: three steps
    against the JAX trainer so configured, to the file's tolerances."""
    run = _jax_train(aggregation="dense_allreduce")
    _port_train_matches(run, "regtopk", "exact", None, "off",
                        aggregation="dense_allreduce")


def test_cli_aggregation_flag(capsys):
    """``--aggregation`` (no choices, JAX's default) is the collective when
    ``--collective`` is not given, and ``--collective`` wins; the comm line
    names the resolved collective."""
    from repro_torch.launch import train

    base = ["--smoke", "--workers", "2", "--steps", "1", "--seq", "16",
            "--device", "cpu"]
    assert train.parse_args(base).collective is None
    assert train.parse_args(base).aggregation == "sparse_allgather"
    res = train.run(train.parse_args([*base, "--aggregation", "dense_allreduce"]))
    assert "collective=dense_allreduce" in capsys.readouterr().out
    assert res.dist.resolved_collective() == "dense_allreduce"
    res = train.run(train.parse_args([*base, "--aggregation", "dense_allreduce",
                                      "--collective", "hierarchical"]))
    assert "collective=hierarchical" in capsys.readouterr().out
