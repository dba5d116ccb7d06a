"""The port's per-leaf (codec x collective) planner
(``repro_torch.comm.autotune``) and its ``"auto"`` paths, against the
JAX package's ``repro.comm.autotune``.

* The planner is host arithmetic over ``comm/cost.py`` (equal to the JAX
  package's since PR 16), so every ``candidate_pairs`` set, every
  ``choose_leaf`` decision (codec, collective, fused, bytes, messages,
  seconds), every ``plan_tree`` / ``replan`` total, bucket and stamp
  equals the JAX package's with ``==``, over a grid of lengths (4 to
  2^20), sparsities, dp layouts ((8,), (2, 4), (1, 2)), link models
  (scalar, uniform and slow-outer ``LinkTopo``), participants, candidate
  restrictions, word sizes, fastpath modes and throughput tables. Both
  sides get the same ``ThroughputTable`` rates: the packages' defaults
  differ (819e9 B/s in the JAX package, the H100's measured 2.98e12 B/s
  in the port), and under a non-"off" fastpath the compute seconds join
  the score.
* ``build_plan`` under ``"auto"`` on paper-resnet-proxy, full width and
  smoke variant, picks the JAX ``build_plan``'s per-leaf codec,
  collective and fused flag; the full-width picks are pinned (8 large
  leaves ``coo_fp32``/``sparse_allgather``, the 3 small ones
  ``coo_idx_delta``, ``bitmap_dense`` with the fastpath on, every leaf
  ``hierarchical`` on a slow-outer (2, 4)); the per-leaf byte and cost
  sums equal the JAX package's.
* The simulator resolves the JAX simulator's wire, and under ``"auto"``
  runs 40 rounds against it (theta to rtol 1e-4, as settled in PR 13).
* The trainer under ``--codec auto --collective auto``: at W = 1 against
  the JAX trainer, at W = 4 against the JAX step composed from
  ``_spa_leaf`` on the JAX plan's per-leaf wires
  (``test_torch_train._jax_composed_train``), to that file's tolerances;
  the fastpath on equals off in f32 bits though the two plans differ in
  the small leaves' (lossless) codec.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType
from jax.sharding import PartitionSpec as P

from repro.comm import autotune as jat
from repro.comm import calibrate as jcal
from repro.comm import fastpath as jfp
from repro.core import DistributedSim as JaxSim
from repro.core import SparsifierConfig as JaxConfig
from repro.core import distributed as jd
from repro.data import pipeline as jpipe
from repro_torch import comm as tcomm
from repro_torch.comm import autotune as tat
from repro_torch.comm import calibrate as tcal
from repro_torch.comm import fastpath as tfp
from repro_torch.convert import linreg_from_jax
from repro_torch.core import DistributedSim, SparsifierConfig
from repro_torch.core import distributed as td
from repro_torch.core.selectors import sparsity_to_k
from repro_torch.data.pipeline import linreg_grad_fn
from repro_torch.tree import tree_items
from test_torch_train import (
    LR,
    RTOL,
    SPARSITY,
    STEPS,
    TINY,
    _batches,
    _batches_w,
    _close,
    _jax_composed_train,
)

JAX_RATE = jfp.ThroughputTable().fused_bps
tcost, jcost = tcomm.cost, jd.comm.cost


def _decision(d):
    return (d.codec, d.collective, d.fused, d.cost.bytes_on_wire,
            d.cost.n_messages, d.cost.seconds)


def _models(mod, dp):
    """Scalar, uniform and (on two axes) slow-outer link models."""
    out = [mod.AlphaBeta(), mod.AlphaBeta(2e-6, 5e-12),
           mod.LinkTopo.uniform(mod.AlphaBeta(3e-6, 2e-11), len(dp))]
    if len(dp) == 2:
        out.append(mod.LinkTopo((mod.AlphaBeta(1e-4, 2e-10),
                                 mod.AlphaBeta(1e-5, 1e-11))))
    return out


RESTRICTIONS = [
    dict(),
    dict(codecs=["coo_q8"], allow_lossy=True),
    dict(collectives=["hierarchical", "dense_allreduce"]),
    dict(codecs=["bitmap_dense", "coo_fp32"], collectives=["sparse_allgather"]),
]


@pytest.mark.parametrize("kw", [
    dict(), dict(allow_lossy=True), dict(codecs=["bitmap_dense"]),
    dict(collectives=["dense_allreduce"]), dict(codecs=["coo_q8"], allow_lossy=True),
    dict(codecs=["coo_idx_delta", "coo_fp32"], collectives=["dense_allreduce",
                                                            "hierarchical"]),
])
def test_candidate_pairs_match_jax(kw):
    assert tat.candidate_pairs(**kw) == jat.candidate_pairs(**kw)


@pytest.mark.parametrize("kw", [
    dict(codecs=["bogus"]), dict(collectives=["bogus"]),
    dict(codecs=["coo_q8"], collectives=["sparse_allgather"]),
])
def test_candidate_pair_errors_match_jax(kw):
    with pytest.raises(ValueError) as je:
        jat.candidate_pairs(**kw)
    with pytest.raises(ValueError) as te:
        tat.candidate_pairs(**kw)
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("fastpath", ["off", "on", "auto"])
@pytest.mark.parametrize("dp", [(8,), (2, 4), (1, 2)], ids=str)
def test_choose_leaf_matches_jax_over_a_grid(dp, fastpath):
    """Every decision equal, with ``==`` on the float seconds: the
    tie-break (seconds, bytes, names) picks the same pair."""
    W = int(np.prod(dp))
    rates = [(JAX_RATE, JAX_RATE), (2e12, 5e11)] if fastpath != "off" else [None]
    n = 0
    for tm, jm in zip(_models(tcost, dp), _models(jcost, dp), strict=True):
        for L in (4, 64, 1000, 4096, 65536, 1 << 20):
            for S in (0.001, 0.01, 0.125, 0.5):
                k = sparsity_to_k(L, S)
                for part in (None, 0.75 * W):
                    for restrict in RESTRICTIONS:
                        for rate in rates:
                            kw = dict(participants=part, fastpath=fastpath,
                                      word_bytes=4 if n % 3 else 2, **restrict)
                            got = tat.choose_leaf(
                                L, k, dp, tm, compute=rate and tfp.ThroughputTable(*rate),
                                **kw)
                            want = jat.choose_leaf(
                                L, k, dp, jm, compute=rate and jfp.ThroughputTable(*rate),
                                **kw)
                            assert _decision(got) == _decision(want), (L, k, kw)
                            n += 1
    assert n > 500


def _tree(mod_plan, jax_side):
    leaves = {"bias": (64, 0.05), "embed": (65536, 0.125), "w": (4096, 0.01),
              "x": (1 << 18, 0.002), "y": (300, 0.3)}
    if jax_side:
        return {n: jd.LeafPlan((L,), (L,), L, sparsity_to_k(L, S), P(None))
                for n, (L, S) in leaves.items()}
    return {n: td.LeafPlan((L,), L, sparsity_to_k(L, S)) for n, (L, S) in leaves.items()}


def _same_comm_plan(got, want):
    assert {n: _decision(d) for n, d in got.decisions.items()} == {
        n: _decision(d) for n, d in want.decisions.items()}
    assert (got.total_bytes, got.total_messages, got.total_seconds) == (
        want.total_bytes, want.total_messages, want.total_seconds)
    assert [(lk.alpha, lk.beta) for lk in got.model.links] == [
        (lk.alpha, lk.beta) for lk in want.model.links]
    assert [_decision(d) for d in got.flat()] == [_decision(d) for d in want.flat()]
    if want.buckets is None:
        assert got.buckets is None and got.timeline is None
    else:
        assert [tuple(b) for b in got.buckets.buckets] == [
            tuple(b) for b in want.buckets.buckets]
        assert tuple(got.timeline) == tuple(want.timeline)


@pytest.mark.parametrize("n_buckets", [None, 1, 2, 3])
@pytest.mark.parametrize("dp", [(8,), (2, 4)], ids=str)
def test_plan_tree_matches_jax(dp, n_buckets):
    """Decisions, totals, the scored topology and, with ``overlap=``, the
    buckets and their timeline."""
    for tm, jm in zip(_models(tcost, dp), _models(jcost, dp), strict=True):
        for kw in (dict(), dict(collectives=["hierarchical"]),
                   dict(fastpath="on", participants=6.0)):
            got = tat.plan_tree(
                _tree(td, False), dp, tm, compute=tfp.ThroughputTable(JAX_RATE, JAX_RATE),
                overlap=n_buckets and tcomm.OverlapConfig(n_buckets=n_buckets), **kw)
            want = jat.plan_tree(
                _tree(jd, True), dp, jm,
                overlap=n_buckets and jd.comm.OverlapConfig(n_buckets=n_buckets), **kw)
            _same_comm_plan(got, want)
            if n_buckets:
                assert got.timeline.seconds <= got.total_seconds + 1e-12


def _rows(alpha, beta, noise_seed=None):
    rows = [(7, 1000), (14, 100_000), (3, 5_000_000), (15, 40_000), (1, 10)]
    rng = np.random.default_rng(noise_seed)
    return [(m, b, m * alpha + b * beta
             + (0.0 if noise_seed is None else float(rng.normal(0, 1e-6))))
            for m, b in rows]


@pytest.mark.parametrize("alpha,beta,noise", [
    (1e-4, 1e-9, None), (2e-5, 3e-10, 1), (1e-6, 1e-12, 2), (0.0, 1e-9, None),
])
def test_replan_matches_jax(alpha, beta, noise):
    """The model fitted from the same sample rows, the decisions at the
    plan's k and at ``k_overrides``, and with an overlap schedule."""
    rows = _rows(alpha, beta, noise)
    ts = [tcal.Sample("probe", i, m, b, s) for i, (m, b, s) in enumerate(rows)]
    js = [jcal.Sample("probe", i, m, b, s) for i, (m, b, s) in enumerate(rows)]
    k_over = {"bias": 2, "embed": 100, "w": 41, "x": 5000, "y": 1}
    for dp in ((8,), (2, 4)):
        for kw in (dict(), dict(overlap="2"), dict(fastpath="on")):
            tkw, jkw = dict(kw), dict(kw)
            if "overlap" in kw:
                tkw["overlap"] = tcomm.OverlapConfig(n_buckets=2)
                jkw["overlap"] = jd.comm.OverlapConfig(n_buckets=2)
            if "fastpath" in kw:
                tkw["compute"] = tfp.ThroughputTable(JAX_RATE, JAX_RATE)
            for ko in (None, k_over):
                _same_comm_plan(
                    tat.replan(_tree(td, False), dp, ts, k_overrides=ko, **tkw),
                    jat.replan(_tree(jd, True), dp, js, k_overrides=ko, **jkw))


# ---------------------------------------------------------------------------
# build_plan under "auto"
# ---------------------------------------------------------------------------
def _proxy_shapes(smoke: bool):
    from repro_torch import configs
    from repro_torch.models import lm

    cfg = configs.get_config("paper-resnet-proxy")
    params = lm.init(cfg.smoke_variant() if smoke else cfg, seed=0, device="cpu")
    return {path: tuple(x.shape) for path, x in tree_items(params)}


BUILD_CASES = {
    "fastpath-off": dict(),
    "fastpath-on": dict(fastpath="on"),
    "slow-outer": dict(dp=(2, 4), topo=((1e-4, 2e-10), (1e-5, 1e-11))),
    "participation": dict(participation="round_robin:2"),
    "adaptive": dict(adaptive_k="1.0,0.001,0.012", fastpath="on"),
    "fixed-codec": dict(codec="coo_q8"),
    "fixed-collective": dict(collective="hierarchical", dp=(2, 4)),
}


def _auto_dists(case):
    """The port's and the JAX package's ``DistConfig`` of a build case, and
    its dp sizes."""
    c = dict(BUILD_CASES[case])
    dp = c.pop("dp", (8,))
    topo = c.pop("topo", None)
    part = c.pop("participation", None)
    adaptive = c.pop("adaptive_k", None)
    fields = dict(codec="auto", collective="auto", fastpath="off")
    fields.update(c)

    def mk(mod, dcls, scfg):
        return dcls(
            sparsifier=scfg(kind="regtopk", sparsity=0.01),
            link_topo=topo and mod.LinkTopo(tuple(mod.AlphaBeta(*ab) for ab in topo)),
            participation=part and mod.parse_participation(part),
            adaptive_k=adaptive and mod.parse_adaptive_k(adaptive),
            **fields)

    axes = ("pod", "data")[-len(dp):]
    jdist = mk(jd.comm, lambda **kw: jd.DistConfig(dp_axes=axes, **kw), JaxConfig)
    return mk(tcomm, td.DistConfig, SparsifierConfig), jdist, dp, axes


def _plans(case, smoke):
    shapes = _proxy_shapes(smoke)
    tdist, jdist, dp, axes = _auto_dists(case)

    class _Mesh:
        shape = dict(zip(axes, dp, strict=True))

    plan = td.build_plan({p: torch.empty(s) for p, s in shapes.items()}, 0.01, tdist,
                         tfp.ThroughputTable(JAX_RATE, JAX_RATE), workers=dp)
    jplan = jd.build_plan({p: jax.ShapeDtypeStruct(s, jnp.float32)
                           for p, s in shapes.items()},
                          {p: P() for p in shapes}, _Mesh(), 0.01, jdist)
    return plan, jplan, tdist, jdist, _Mesh()


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("case", list(BUILD_CASES))
def test_build_plan_auto_matches_jax(case, smoke):
    """Per-leaf codec, collective and fused flag, the capacity k, and the
    round's predicted and measured bytes and alpha–beta cost, summed over
    the per-leaf choices."""
    plan, jplan, tdist, jdist, mesh = _plans(case, smoke)
    for path, p in plan.items():
        jp = jplan[path]
        assert (p.local_len, p.k, p.codec, p.collective, p.fused) == (
            jp.local_len, jp.k, jp.codec, jp.collective, bool(jp.fused)), path
        assert td.leaf_wire(p, tdist) == jd.leaf_wire(jp, jdist)
    dp = tuple(mesh.shape.values())
    assert td.comm_round_bytes(plan, tdist, dp) == jd.comm_round_bytes(jplan, jdist, mesh)
    got, want = td.comm_round_cost(plan, tdist, dp), jd.comm_round_cost(jplan, jdist, mesh)
    assert (got.bytes_on_wire, got.n_messages, got.seconds) == (
        want.bytes_on_wire, want.n_messages, want.seconds)


def test_build_plan_auto_full_width_picks():
    """The JAX planner's picks on paper-resnet-proxy at full width (11
    leaves, S = 0.01, W = 8, ``AlphaBeta()``), held in the port."""
    def picks(case):
        plan = _plans(case, False)[0]
        large = {p for p, lp in plan.items() if lp.local_len > 1024}
        return ({(lp.codec, lp.collective, lp.fused) for p, lp in plan.items()
                 if p in large},
                {(lp.codec, lp.collective, lp.fused) for p, lp in plan.items()
                 if p not in large}, len(large), len(plan))

    assert picks("fastpath-off") == (
        {("coo_fp32", "sparse_allgather", False)},
        {("coo_idx_delta", "sparse_allgather", False)}, 8, 11)
    assert picks("fastpath-on") == (
        {("coo_fp32", "sparse_allgather", True)},
        {("bitmap_dense", "sparse_allgather", False)}, 8, 11)
    assert {lp.collective for lp in _plans("slow-outer", False)[0].values()} == {
        "hierarchical"}
    plan, _, tdist, _, _ = _plans("fastpath-off", False)
    assert round(td.comm_round_cost(plan, tdist, 8).seconds * 1e3, 3) == 0.795


def test_auto_needs_the_dp_layout_and_resolves_leaf_wires():
    dist = td.DistConfig(codec="auto")
    with pytest.raises(ValueError, match="pass build_plan"):
        td.build_plan({"w": torch.zeros(64)}, 0.05, dist)
    with pytest.raises(ValueError, match="auto") as te:
        td.leaf_wire(td.LeafPlan((64,), 64, 4), dist)
    with pytest.raises(ValueError) as je:
        jd.leaf_wire(jd.LeafPlan((64,), (64,), 64, 4, P(None)),
                     jd.DistConfig(codec="auto"))
    assert str(te.value) == str(je.value)
    fixed = td.DistConfig(codec="coo_fp32", collective="sparse_allgather")
    plan = td.build_plan({"w": torch.zeros(64)}, 0.05, fixed)
    assert plan["w"].codec is None
    assert td.leaf_wire(plan["w"], fixed) == ("coo_fp32", "sparse_allgather")


@pytest.mark.parametrize("kind", ["none", "hard_threshold"])
def test_auto_forces_dense_for_variable_cardinality_kinds(kind):
    dist = td.DistConfig(sparsifier=SparsifierConfig(kind=kind, sparsity=0.05),
                         codec="auto", collective="auto")
    plan = td.build_plan({"w": torch.zeros(4096)}, 0.05, dist, workers=8)
    jdist = jd.DistConfig(sparsifier=JaxConfig(kind=kind, sparsity=0.05),
                          codec="auto", collective="auto")

    class _Mesh:
        shape = {"data": 8}

    jplan = jd.build_plan({"w": jax.ShapeDtypeStruct((4096,), jnp.float32)},
                          {"w": P(None)}, _Mesh(), 0.05, jdist)
    assert plan["w"].collective == jplan["w"].collective == "dense_allreduce"
    assert plan["w"].codec == jplan["w"].codec


def test_apply_plan_decisions_matches_jax():
    """``replan``'s picks grafted onto the plan: wires and fused flags
    replaced, capacities kept."""
    rows = _rows(1e-4, 1e-9)
    tplan, jplan = _tree(td, False), _tree(jd, True)
    got = td.apply_plan_decisions(tplan, tat.replan(
        tplan, (8,), [tcal.Sample("p", i, *r) for i, r in enumerate(rows)],
        fastpath="on", compute=tfp.ThroughputTable(JAX_RATE, JAX_RATE)))
    want = jd.apply_plan_decisions(jplan, jat.replan(
        jplan, (8,), [jcal.Sample("p", i, *r) for i, r in enumerate(rows)],
        fastpath="on"))
    for name, p in got.items():
        w = want[name]
        assert (p.k, p.codec, p.collective, p.fused) == (w.k, w.codec, w.collective,
                                                          w.fused)
    assert td.apply_plan_decisions(tplan, tat.plan_tree(tplan, (8,)).decisions) == \
        td.apply_plan_decisions(tplan, tat.plan_tree(tplan, (8,)))


# ---------------------------------------------------------------------------
# the simulator under "auto"
# ---------------------------------------------------------------------------
SIM_AUTO = [
    dict(),
    dict(dp_shape=(2, 4), topo=((1e-4, 2e-10), (1e-5, 1e-11))),
    dict(link_model=(2e-6, 5e-12), sparsity=0.5),
    dict(participation="round_robin:3"),
    dict(participation="stale:2,2,0.5"),
    dict(adaptive_k="1.0,2,32"),
    dict(codec="coo_q8"),
    dict(collective="dense_allreduce"),
    dict(kind="none"),
    dict(kind="hard_threshold"),
]


def _sim_kw(mod, c):
    c = dict(c)
    kw = dict(codec=c.pop("codec", "auto"), collective=c.pop("collective", "auto"))
    if "dp_shape" in c:
        kw["dp_shape"] = c.pop("dp_shape")
    if "topo" in c:
        kw["link_topo"] = mod.LinkTopo(tuple(mod.AlphaBeta(*ab) for ab in c.pop("topo")))
    if "link_model" in c:
        kw["link_model"] = mod.AlphaBeta(*c.pop("link_model"))
    if "participation" in c:
        kw["participation"] = mod.parse_participation(c.pop("participation"))
    if "adaptive_k" in c:
        kw["adaptive_k"] = mod.parse_adaptive_k(c.pop("adaptive_k"))
    return kw, dict(kind=c.pop("kind", "regtopk"), sparsity=c.pop("sparsity", 0.05),
                    mu=1.0, threshold=0.5)


@pytest.mark.parametrize("case", range(len(SIM_AUTO)))
def test_sim_auto_resolves_the_jax_wire(case):
    for L in (64, 4096, 65536):
        jkw, jcfg = _sim_kw(jd.comm, SIM_AUTO[case])
        tkw, tcfg = _sim_kw(tcomm, SIM_AUTO[case])
        jsim = JaxSim(None, 8, L, JaxConfig(**jcfg), **jkw)
        tsim = DistributedSim(None, 8, L, SparsifierConfig(**tcfg), device="cpu", **tkw)
        assert (tsim.codec, tsim.resolved_collective, tsim.aggregation) == (
            jsim.codec, jsim.resolved_collective, jsim.aggregation)
        got, want = tsim.wire_bytes_per_round(), jsim.wire_bytes_per_round()
        assert (got.bytes_on_wire, got.n_messages, got.seconds) == (
            want.bytes_on_wire, want.n_messages, want.seconds)


def test_sim_auto_keeps_an_explicit_payload_collective_for_hard_threshold():
    cfg = SparsifierConfig(kind="hard_threshold", threshold=0.1)
    assert DistributedSim(None, 2, 2, cfg, codec="auto", collective="auto",
                          device="cpu").resolved_collective == "dense_allreduce"
    with pytest.raises(ValueError, match="hard_threshold"):
        DistributedSim(None, 2, 2, cfg, codec="auto", collective="sparse_allgather",
                       device="cpu")


@pytest.fixture(scope="module")
def linreg():
    jdata = jpipe.make_linreg(3, 4, 64, 100)
    return jdata, linreg_from_jax(jax.tree.map(np.asarray, jdata), device="cpu")


@pytest.mark.parametrize("case", [
    dict(), dict(dp_shape=(2, 2), topo=((1e-4, 2e-10), (1e-5, 1e-11))),
    dict(link_model=(1e-7, 1e-9), sparsity=0.5), dict(codec="coo_q8"),
], ids=["default", "slow-outer", "beta-heavy", "q8"])
def test_sim_auto_runs_match_jax(linreg, case):
    """40 rounds of the paper's linear regression under ``"auto"``: the
    JAX simulator's wire, its masks for 5 rounds exactly and its theta to
    rtol 1e-4 (``coo_q8`` with the absolute 1e-3 of
    ``test_torch_simulator.py``)."""
    jdata, tdata = linreg
    jkw, jcfg = _sim_kw(jd.comm, case)
    tkw, tcfg = _sim_kw(tcomm, case)
    jcfg.update(sparsity=jcfg["sparsity"] if "sparsity" in case else 0.25, mu=16.0)
    tcfg.update(sparsity=jcfg["sparsity"], mu=16.0)
    jsim = JaxSim(jpipe.linreg_grad_fn(jdata), 4, 64, JaxConfig(**jcfg),
                  learning_rate=1e-2, **jkw)
    tsim = DistributedSim(linreg_grad_fn(tdata), 4, 64, SparsifierConfig(**tcfg),
                          learning_rate=1e-2, device="cpu", **tkw)
    assert (tsim.codec, tsim.resolved_collective) == (jsim.codec,
                                                      jsim.resolved_collective)
    jfin, jmasks = jsim.run(jnp.zeros(64), 40,
                            trace_state_fn=lambda s: s.worker_states.s_prev)
    tfin, tmasks = tsim.run(torch.zeros(64), 40,
                            trace_state_fn=lambda s: s.worker_states.s_prev)
    np.testing.assert_array_equal(tmasks[:5].numpy(), np.asarray(jmasks)[:5])
    np.testing.assert_allclose(tfin.theta.numpy(), np.asarray(jfin.theta), rtol=1e-4,
                               atol=1e-3 if tsim.codec == "coo_q8" else 1e-5)


# ---------------------------------------------------------------------------
# the trainer under --codec auto --collective auto
# ---------------------------------------------------------------------------
def _port_train(W, params, batches, fastpath="off", table=None, **fields):
    from repro_torch.models.config import ModelConfig
    from repro_torch.optim import OptConfig, make_optimizer

    cfg = ModelConfig(**TINY)
    dist = td.DistConfig(
        sparsifier=SparsifierConfig(kind="regtopk", sparsity=SPARSITY),
        optimizer=OptConfig(kind="adam", learning_rate=LR),
        codec="auto", collective="auto", fastpath=fastpath, **fields)
    plan = td.build_plan(params, SPARSITY, dist, table, workers=W)
    step = td.make_train_step(cfg, dist, plan, W)
    opt_state = make_optimizer(dist.optimizer).init(params)
    sp = td.init_sparsifier_state(plan, W, "cpu")
    losses = []
    for b in batches:
        tb = {k: torch.from_numpy(v).long() for k, v in b.items()}
        params, opt_state, sp, m = step(params, opt_state, sp, tb)
        losses.append(float(m["loss"]))
    return losses, params, sp, plan


def _jax_auto_w1():
    """Three JAX train steps at W = 1 under ``codec``/``collective="auto"``
    (``assemble`` on a one-device mesh): (initial params, losses, final
    params, state, plan)."""
    from repro.models import get_family
    from repro.models.config import ModelConfig as JaxModelConfig
    from repro.optim import OptConfig as JaxOptConfig
    from repro.optim import make_optimizer as jax_make_optimizer

    cfg = JaxModelConfig(family="dense", remat=False, **TINY)
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto))
    dist = jd.DistConfig(sparsifier=JaxConfig(kind="regtopk", sparsity=SPARSITY),
                         optimizer=JaxOptConfig(kind="adam", learning_rate=LR),
                         dp_axes=("data",), codec="auto", collective="auto")
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
            params, opt_state, sp, m = step(params, opt_state, sp,
                                            jax.tree.map(jnp.asarray, b))
            losses.append(float(m["loss"]))
    return p0, losses, jax.tree.map(np.asarray, params), sp, asm.plan


def _same_plan_as_jax(plan, jplan):
    """Leaf by leaf, in both trees' order: length, k and wire."""
    jleaves = jax.tree.leaves(jplan, is_leaf=jd._is_plan)
    for (path, p), jp in zip(tree_items(plan), jleaves, strict=True):
        assert (p.local_len, p.k, p.codec, p.collective) == (
            jp.local_len, jp.k, jp.codec, jp.collective), path


def test_auto_train_steps_match_jax_at_one_worker():
    """At W = 1 there is no wire: every pair prices 0 s and 0 bytes, and
    the names break the tie, in both packages (``bitmap_dense`` +
    ``hierarchical``, whose one-axis round is ``sparse_allgather``'s)."""
    from repro_torch import convert

    p0, jlosses, jparams, jsp, jplan = _jax_auto_w1()
    losses, params, sp, plan = _port_train(1, convert.params_from_jax(p0, device="cpu"),
                                           _batches(STEPS))
    _same_plan_as_jax(plan, jplan)
    assert {(p.codec, p.collective) for _, p in tree_items(plan)} == {
        ("bitmap_dense", "hierarchical")}
    np.testing.assert_allclose(losses, jlosses, rtol=RTOL)
    for path, leaf in tree_items(params):
        _close(leaf.numpy(), dict(tree_items(jparams))[path], path)
    jstates = dict(tree_items(jsp))
    for path, st in tree_items(sp):
        np.testing.assert_array_equal(st.t.numpy(), np.asarray(jstates[path].t))
        np.testing.assert_array_equal(
            np.sort(st.sent_idx.numpy()[0]),
            np.sort(np.asarray(jstates[path].sent_idx).reshape(-1)), err_msg=path)


def test_auto_train_steps_match_jax_at_four_workers():
    """W = 4 on one card against the JAX step composed from ``_spa_leaf``,
    each leaf on the wire the JAX ``build_plan`` picked (the port picks
    the same): losses and params to the file's tolerances, the sent sets
    by index. Planned with the fastpath on, which prices the fused
    kernel's padded tile, so the small leaves take ``bitmap_dense`` and
    the rest a COO codec: a mixed wire (the JAX round runs unfused, equal
    to its fused round in bits)."""
    from repro_torch import convert

    W = 4
    jdist = jd.DistConfig(sparsifier=JaxConfig(kind="regtopk", sparsity=SPARSITY),
                          codec="auto", collective="auto", fastpath="on")
    p0, jlosses, _, jparams, jstate, _, jplan = _jax_composed_train(W, dist=jdist)
    losses, params, sp, plan = _port_train(
        W, convert.params_from_jax(p0, device="cpu"), _batches_w(STEPS, W),
        fastpath="on", table=tfp.ThroughputTable(JAX_RATE, JAX_RATE))
    _same_plan_as_jax(plan, jplan)
    assert len({p.codec for _, p in tree_items(plan)}) > 1
    np.testing.assert_allclose(losses, jlosses, rtol=RTOL)
    for path, leaf in tree_items(params):
        _close(leaf.numpy(), dict(tree_items(jparams))[path], path)
    from repro.core import compact as jc

    jflat = jax.tree.leaves(jstate, is_leaf=lambda x: isinstance(x, jc.CompactState))
    for (path, st), js in zip(tree_items(sp), jflat, strict=True):
        jidx = np.asarray(js.sent_idx).reshape(W, -1)
        for w in range(W):
            np.testing.assert_array_equal(np.sort(st.sent_idx.numpy()[w]),
                                          np.sort(jidx[w]), err_msg=f"{path} w{w}")


def test_auto_fastpath_on_equals_off_in_bits():
    """Under ``"auto"`` the fastpath changes the plan (the small leaves go
    from ``coo_idx_delta`` to ``bitmap_dense``, both lossless), and the
    params stay equal in f32 bits: each worker decodes each index once and
    the workers add in worker order."""
    from repro_torch.models import lm
    from repro_torch.models.config import ModelConfig

    W = 4
    runs = {mode: _port_train(W, lm.init(ModelConfig(**TINY), seed=0, device="cpu"),
                              _batches_w(STEPS, W), fastpath=mode)
            for mode in ("off", "on")}
    plans = {m: [(p.codec, p.fused) for _, p in tree_items(r[3])] for m, r in runs.items()}
    assert plans["on"] != plans["off"] and any(f for _, f in plans["on"])
    for (path, a), (_, b) in zip(tree_items(runs["on"][1]), tree_items(runs["off"][1]),
                                 strict=True):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32)), path


@pytest.mark.parametrize("flags", [
    ["--codec", "auto", "--collective", "auto"],
    ["--codec", "auto", "--collective", "auto", "--overlap", "buckets:2",
     "--fastpath", "on"],
    ["--codec", "coo_idx_delta", "--collective", "auto", "--link-topo",
     "data:1e-4,1e-9"],
])
def test_cli_takes_auto_and_overlap(flags, capsys):
    """The JAX trainer's lines: the comm line, ``auto-plan`` per (codec,
    collective), and the overlap line."""
    import re

    from repro_torch.launch import train

    res = train.run(train.parse_args(["--smoke", "--workers", "2", "--steps", "2",
                                      "--seq", "16", "--device", "cpu", *flags]))
    out = capsys.readouterr().out
    assert all(np.isfinite(res.losses)) and len(res.losses) == 2
    picks = re.findall(r"^comm:   auto-plan (\w+)/(\w+): (\d+) leaves$", out, re.M)
    assert sum(int(n) for *_, n in picks) == len(tree_items(res.plan)) > 0
    assert {(c, s) for c, s, _ in picks} == {
        (p.codec, p.collective) for _, p in tree_items(res.plan)}
    if "coo_idx_delta" in flags:
        assert {c for c, _, _ in picks} == {"coo_idx_delta"}
    if "--overlap" in flags:
        assert re.search(r"^comm:   overlap \d buckets \(buckets:2\): [\d.]+ ms sync -> "
                         r"[\d.]+ ms overlapped$", out, re.M)
