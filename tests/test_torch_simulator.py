"""The port's simulator against the JAX package's, round by round.

* the paper's Fig. 1 toy (2 workers, J = 2): the traces of Top-1,
  RegTop-1 and no sparsification agree with the JAX package's to rtol
  1e-5, and the port makes the same assertions as
  ``tests/test_sparsify.py::test_fig1_topk_stuck_regtopk_tracks``;
* distributed linear regression on the JAX package's own
  ``make_linreg(3, 4, 64, 100)`` arrays (``convert.linreg_from_jax``), 40
  rounds of every kind under both collectives: the per-round masks are
  exact for the first 5 rounds and the final theta agrees to rtol 1e-4
  (XLA:CPU and PyTorch sum the float32 products of the gradient and the
  aggregation in other orders, and 40 rounds carry that difference);
* a run continued from a JAX state (``convert.sim_state_from_jax``);
* the fastpath on equals off with ``torch.equal`` (RegTop-k through the
  kernel wrapper, which computes the plain chain on the CPU) at y = 1
  and y = 2; ``"auto"`` declines on the CPU; every refused option or
  combination raises with the JAX simulator's message;
* each codec, ``hierarchical`` and coordinate weighting, 40 rounds
  against the JAX simulator as above, and ``wire_bytes_per_round``
  equal to the JAX package's;
* partial participation (``round_robin``, ``stale``, ``sampled``,
  ``bernoulli``) for topk, regtopk, dgc and coordtopk, and the adaptive-k
  controller, 40 rounds against the JAX simulator, with ``bernoulli`` and
  ``sampled`` sharing the port's masks (``_share_masks``): theta to rtol
  1e-4, the controller's k trajectory exactly; a full schedule and a
  controller pinned at the static k equal the static full path in bits,
  and the fastpath on equals off under every partial round.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import DistributedSim as JaxSim
from repro.core import SparsifierConfig as JaxConfig
from repro.data import pipeline as jpipe
from repro_torch.comm.controller import AdaptiveKController
from repro_torch.comm.participation import Participation
from repro_torch.convert import linreg_from_jax, sim_state_from_jax, sim_state_to_numpy
from repro_torch.core import DistributedSim, SparsifierConfig
from repro_torch.data.pipeline import linreg_grad_fn
import _torch_cores  # noqa: F401  (this worker's share of the cores)

KINDS = ["none", "topk", "regtopk", "hard_threshold", "coordtopk", "dgc"]
TOY_X = np.array([[100.0, 1.0], [-100.0, 1.0]], np.float32)


def _toy_traces(kind):
    xj, xt = jnp.asarray(TOY_X), torch.from_numpy(TOY_X)

    def jgrad(theta, n):
        e = jnp.exp(-jnp.dot(theta, xj[n]))
        return -e * xj[n] / (1 + e)

    def tgrad(theta, widx):
        xn = xt[widx]
        e = torch.exp(-(xn @ theta))[:, None]
        return -e * xn / (1 + e)

    jsim = JaxSim(jgrad, 2, 2, JaxConfig(kind=kind, sparsity=0.5, mu=1.0),
                  learning_rate=0.9)
    _, jtr = jsim.run(jnp.array([0.0, 1.0]), 60,
                      trace_fn=lambda th: jnp.mean(jnp.log(1 + jnp.exp(-xj @ th))))
    tsim = DistributedSim(tgrad, 2, 2, SparsifierConfig(kind=kind, sparsity=0.5, mu=1.0),
                          learning_rate=0.9, device="cpu")
    _, ttr = tsim.run(torch.tensor([0.0, 1.0]), 60,
                      trace_fn=lambda th: torch.log(1 + torch.exp(-xt @ th)).mean())
    return np.asarray(jtr), ttr.numpy()


def test_fig1_toy_matches_jax():
    t = {}
    for kind in ("topk", "regtopk", "none"):
        jtr, ttr = _toy_traces(kind)
        np.testing.assert_allclose(ttr, jtr, rtol=1e-5, err_msg=kind)
        t[kind] = ttr
    assert t["topk"][49] == pytest.approx(t["topk"][0])  # stuck
    assert t["regtopk"][49] < 0.05  # converging
    assert abs(t["regtopk"][49] - t["none"][49]) < 0.01  # tracks ideal


@pytest.fixture(scope="module")
def linreg():
    jdata = jpipe.make_linreg(3, 4, 64, 100)
    tdata = linreg_from_jax(jax.tree.map(np.asarray, jdata), device="cpu")
    return jdata, tdata


CASES = [(k, c) for k in KINDS for c in ("dense_allreduce", "sparse_allgather")
         if not (k == "hard_threshold" and c == "sparse_allgather")]


def _cfg(kind, cls):
    return cls(kind=kind, sparsity=0.25, mu=16.0, threshold=0.5)


@pytest.mark.parametrize("kind,collective", CASES)
def test_linreg_matches_jax(linreg, kind, collective):
    jdata, tdata = linreg
    jsim = JaxSim(jpipe.linreg_grad_fn(jdata), 4, 64, _cfg(kind, JaxConfig),
                  learning_rate=1e-2, aggregation=collective)
    jfin, jmasks = jsim.run(jnp.zeros(64), 40,
                            trace_state_fn=lambda s: s.worker_states.s_prev)
    tsim = DistributedSim(linreg_grad_fn(tdata), 4, 64, _cfg(kind, SparsifierConfig),
                          learning_rate=1e-2, aggregation=collective, device="cpu")
    tfin, tmasks = tsim.run(torch.zeros(64), 40,
                            trace_state_fn=lambda s: s.worker_states.s_prev)
    np.testing.assert_array_equal(tmasks[:5].numpy(), np.asarray(jmasks)[:5])
    np.testing.assert_allclose(tfin.theta.numpy(), np.asarray(jfin.theta),
                               rtol=1e-4, atol=1e-5)
    assert tfin.step == 40


def test_run_continues_from_a_jax_state(linreg):
    """20 JAX rounds, then 5 more in each stack from the same state."""
    jdata, tdata = linreg
    cfg = dict(kind="regtopk", sparsity=0.25, mu=16.0)
    jsim = JaxSim(jpipe.linreg_grad_fn(jdata), 4, 64, JaxConfig(**cfg),
                  learning_rate=1e-2, aggregation="sparse_allgather")
    st = jsim.init(jnp.zeros(64))
    for _ in range(20):
        st, _ = jsim.step_fn(st)
    tsim = DistributedSim(linreg_grad_fn(tdata), 4, 64, SparsifierConfig(**cfg),
                          learning_rate=1e-2, aggregation="sparse_allgather",
                          device="cpu")
    tst = sim_state_from_jax(jax.tree.map(np.asarray, st), device="cpu")
    assert tst.step == 20
    for _ in range(5):
        st, jg = jsim.step_fn(st)
        tst, tg = tsim.step_fn(tst)
        np.testing.assert_array_equal(
            tst.worker_states.s_prev.numpy(), np.asarray(st.worker_states.s_prev)
        )
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-6)
    got = sim_state_to_numpy(tst)
    assert got["step"] == 25
    np.testing.assert_allclose(got["theta"], np.asarray(st.theta), rtol=1e-5)


@pytest.mark.parametrize("y", [1.0, 2.0])
@pytest.mark.parametrize("collective", ["dense_allreduce", "sparse_allgather"])
def test_fastpath_on_equals_off(linreg, collective, y):
    """Through the kernel wrapper (the plain chain on the CPU) and without
    it, the runs agree bit for bit. At y = 1.5 the CPU gives no such
    guarantee: PyTorch's CPU pow can differ in the last bit between its
    vectorised body and its scalar tail, and the tiled layout moves
    elements between the two; the card has no such split."""
    _, tdata = linreg
    out = {}
    for mode in ("off", "on"):
        sim = DistributedSim(
            linreg_grad_fn(tdata), 4, 64,
            SparsifierConfig(kind="regtopk", sparsity=0.25, mu=16.0, y=y),
            learning_rate=1e-2, aggregation=collective, fastpath=mode,
            device="cpu",
        )
        assert (sim.sparsifier.cfg.score_fn is not None) == (mode == "on")
        out[mode] = sim.run(torch.zeros(64), 40,
                            trace_state_fn=lambda s: s.worker_states.s_prev)
    assert torch.equal(out["on"][1], out["off"][1])
    assert torch.equal(out["on"][0].theta, out["off"][0].theta)
    assert torch.equal(out["on"][0].g_agg_prev, out["off"][0].g_agg_prev)


def _sim(**kw):
    args = dict(grad_fn=None, n_workers=4, length=64,
                sparsifier_cfg=SparsifierConfig(kind="regtopk"), device="cpu")
    args.update(kw)
    return DistributedSim(**args)


def test_auto_declines_on_the_cpu():
    assert _sim(fastpath="auto").sparsifier.cfg.score_fn is None
    assert _sim(fastpath="on").sparsifier.cfg.score_fn is not None
    assert _sim(fastpath="on", sparsifier_cfg=SparsifierConfig(kind="topk")
                ).sparsifier.cfg.score_fn is None


@pytest.mark.parametrize("kw,match", [
    (dict(participation=Participation("stale"), weighting="coordinate"),
     "does not compose"),
    (dict(adaptive_k=AdaptiveKController(budget=0.1),
          sparsifier_cfg=SparsifierConfig(kind="dgc")), "adaptive_k drives"),
    (dict(overlap="stream"), "unknown overlap spec"),
    (dict(weighting="coordinate", fastpath="on"), "scalar omega"),
    (dict(weighting="per-worker"), "unknown weighting"),
    (dict(weighting="coordinate",
          sparsifier_cfg=SparsifierConfig(kind="none")), "sparse payloads"),
    (dict(codec="bogus"), "unknown codec"),
    (dict(codec="auto", sparsifier_cfg=SparsifierConfig(kind="hard_threshold"),
          collective="sparse_allgather"), "hard_threshold"),
    (dict(dp_shape=(3, 2)), "does not factor"),
    (dict(overlap="buckets:0"), "n_buckets must be >= 1"),
    (dict(aggregation="ring"), "unknown collective"),
    (dict(fastpath="always"), "unknown fastpath"),
    (dict(sparsifier_cfg=SparsifierConfig(kind="hard_threshold"),
          collective="sparse_allgather"), "hard_threshold"),
])
def test_unsupported_options_raise(kw, match):
    with pytest.raises(ValueError, match=match):
        _sim(**kw)


def test_cost_methods_wait_for_comm_cost():
    """``wire_bytes_per_round`` is ported with ``comm/cost.py`` (its
    numbers are held against the JAX package's below);
    ``round_timeline`` needs a schedule, as the JAX simulator's does: it
    raises with overlap "off"."""
    est = _sim().wire_bytes_per_round()
    assert est.bytes_on_wire > 0 and est.seconds > 0
    with pytest.raises(ValueError, match="overlap != 'off'"):
        _sim().round_timeline()


def test_full_participation_schedule_is_accepted():
    sim = _sim(participation=Participation("full"))
    assert sim.n_workers == 4 and sim.sparsifier.cfg.omega == 0.25


def test_cuda_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _sim(device="cuda")


WIRE_CASES = [
    ("regtopk", "coo_idx_delta", "sparse_allgather", "worker"),
    ("regtopk", "bitmap_dense", "sparse_allgather", "worker"),
    ("regtopk", "coo_q8", "sparse_allgather", "worker"),
    ("topk", "coo_q8", "sparse_allgather", "worker"),
    ("regtopk", "coo_idx_delta", "hierarchical", "worker"),
    ("regtopk", "coo_fp32", "sparse_allgather", "coordinate"),
    ("regtopk", "coo_q8", "hierarchical", "coordinate"),
    ("regtopk", "coo_fp32", "dense_allreduce", "coordinate"),
    ("topk", "bitmap_dense", "sparse_allgather", "coordinate"),
]


@pytest.mark.parametrize("kind,codec,collective,weighting", WIRE_CASES)
def test_wire_options_match_jax(linreg, kind, codec, collective, weighting):
    """Each codec (``coo_q8``'s residual folded back into the state),
    ``hierarchical`` and coordinate weighting, 40 rounds against the JAX
    simulator: the masks of the first 5 rounds exact, the final theta to
    rtol 1e-4 as in ``test_linreg_matches_jax``; under coordinate
    weighting the last round's sender mass too. ``coo_q8`` is held like
    the lossless codecs: its scale is ``amax * fl(1/127)``, what the jitted
    JAX encode computes (``test_torch_codec.py``)."""
    jdata, tdata = linreg
    kw = dict(learning_rate=1e-2, codec=codec, collective=collective,
              weighting=weighting)
    jsim = JaxSim(jpipe.linreg_grad_fn(jdata), 4, 64, _cfg(kind, JaxConfig), **kw)
    jfin, jmasks = jsim.run(jnp.zeros(64), 40,
                            trace_state_fn=lambda s: s.worker_states.s_prev)
    tsim = DistributedSim(linreg_grad_fn(tdata), 4, 64, _cfg(kind, SparsifierConfig),
                          device="cpu", **kw)
    tfin, tmasks = tsim.run(torch.zeros(64), 40,
                            trace_state_fn=lambda s: s.worker_states.s_prev)
    np.testing.assert_array_equal(tmasks[:5].numpy(), np.asarray(jmasks)[:5])
    np.testing.assert_allclose(tfin.theta.numpy(), np.asarray(jfin.theta),
                               rtol=1e-4, atol=1e-5)
    if weighting == "coordinate":
        np.testing.assert_allclose(tfin.w_agg_prev.numpy(),
                                   np.asarray(jfin.w_agg_prev), rtol=1e-6)
    else:
        assert tfin.w_agg_prev is None


def test_coordinate_run_continues_from_a_jax_state(linreg):
    """``convert.sim_state_from_jax`` carries ``w_agg_prev``: 20 JAX
    rounds under coordinate weighting, then 5 more in each stack."""
    jdata, tdata = linreg
    kw = dict(learning_rate=1e-2, aggregation="sparse_allgather",
              weighting="coordinate")
    jsim = JaxSim(jpipe.linreg_grad_fn(jdata), 4, 64, _cfg("regtopk", JaxConfig), **kw)
    st = jsim.init(jnp.zeros(64))
    for _ in range(20):
        st, _ = jsim.step_fn(st)
    tsim = DistributedSim(linreg_grad_fn(tdata), 4, 64, _cfg("regtopk", SparsifierConfig),
                          device="cpu", **kw)
    tst = sim_state_from_jax(jax.tree.map(np.asarray, st), device="cpu")
    assert torch.equal(tst.w_agg_prev, torch.from_numpy(np.array(st.w_agg_prev)))
    for _ in range(5):
        st, jg = jsim.step_fn(st)
        tst, tg = tsim.step_fn(tst)
        np.testing.assert_array_equal(
            tst.worker_states.s_prev.numpy(), np.asarray(st.worker_states.s_prev))
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(sim_state_to_numpy(tst)["w_agg_prev"],
                               np.asarray(st.w_agg_prev), rtol=1e-6)


@pytest.mark.parametrize("codec", ["coo_fp32", "coo_idx_delta", "bitmap_dense", "coo_q8"])
def test_wire_bytes_per_round_matches_jax(codec):
    from repro.comm import cost as jcost
    from repro_torch.comm import cost as tcost

    for coll, dp, model in [
        ("sparse_allgather", None, None),
        ("hierarchical", (2, 2), None),
        ("dense_allreduce", (4,), "scalar"),
        ("hierarchical", (2, 2), "topo"),
        ("sparse_allgather", (1, 4), "topo"),
    ]:
        def link(mod):
            if model == "scalar":
                return dict(link_model=mod.AlphaBeta(2e-6, 5e-12))
            if model == "topo":
                return dict(link_topo=mod.LinkTopo(
                    (mod.AlphaBeta(1e-5, 1e-9), mod.AlphaBeta(1e-6, 1e-11))))
            return {}

        kw = dict(codec=codec, collective=coll, dp_shape=dp)
        jsim = JaxSim(None, 4, 5000, JaxConfig(kind="regtopk", sparsity=0.01),
                      **kw, **link(jcost))
        tsim = _sim(length=5000, sparsifier_cfg=SparsifierConfig(sparsity=0.01),
                    **kw, **link(tcost))
        want, got = jsim.wire_bytes_per_round(), tsim.wire_bytes_per_round()
        assert (got.bytes_on_wire, got.n_messages, got.seconds) == (
            want.bytes_on_wire, want.n_messages, want.seconds)
        m = tcost.AlphaBeta(3e-6, 2e-11)
        assert tsim.wire_bytes_per_round(m).seconds == jsim.wire_bytes_per_round(
            jcost.AlphaBeta(3e-6, 2e-11)).seconds


def test_auto_declines_the_score_kernel_under_coordinate_weighting(monkeypatch):
    """The score kernel takes a scalar omega: on a card, ``"auto"`` would
    install it, and coordinate weighting must keep the plain chain (the
    JAX package's rule), or the first round would raise."""
    from repro_torch.comm import fastpath

    monkeypatch.setattr(fastpath, "backend_supports", lambda device: True)
    assert _sim(fastpath="auto").sparsifier.cfg.score_fn is not None
    assert _sim(fastpath="auto", weighting="coordinate").sparsifier.cfg.score_fn is None


# ---------------------------------------------------------------------------
# partial participation and the adaptive-k controller
# ---------------------------------------------------------------------------
SCHEDULES = {
    "round_robin": dict(kind="round_robin", n_stragglers=1),
    "stale": dict(kind="stale", n_stragglers=1, staleness=2, discount=0.5),
    "sampled": dict(kind="sampled", n_sampled=2, seed=3),
    "bernoulli": dict(kind="bernoulli", drop_rate=0.25, seed=1),
}
PART_CASES = [
    (kind, sched, "sparse_allgather" if kind in ("regtopk", "coordtopk")
     else "dense_allreduce")
    for kind in ("topk", "regtopk", "dgc", "coordtopk") for sched in SCHEDULES
] + [("regtopk", sched, "dense_allreduce") for sched in SCHEDULES]
ROUNDS = 40


def _share_masks(monkeypatch, part, n, rounds):
    """Make the JAX package's ``Participation`` draw the port's masks and
    cohorts (a lookup by round, traced inside its jitted scan): torch
    cannot reproduce ``jax.random``. Edits nothing in ``src/repro``; the
    round_robin and stale masks need no sharing (they are exact)."""
    from repro.comm.participation import Participation as JaxParticipation

    masks = jnp.asarray(np.stack([part.round_mask(r, n, device="cpu").numpy()
                                  for r in range(rounds)]))
    monkeypatch.setattr(JaxParticipation, "round_mask",
                        lambda self, r, n_workers: masks[r])
    if part.kind == "sampled":
        cohorts = jnp.asarray(np.stack([
            part.round_participants(r, n, device="cpu").numpy().astype(np.int32)
            for r in range(rounds)]))
        monkeypatch.setattr(JaxParticipation, "round_participants",
                            lambda self, r, n_workers: cohorts[r])


def _pair_runs(linreg, kind, collective, monkeypatch, rounds=ROUNDS,
               participation=None, adaptive=None, trace=None):
    """The JAX and the port's simulator, ``rounds`` rounds from zero on the
    shared linear regression: ``((jax final, jax trace), (port final,
    port trace))``."""
    from repro.comm import AdaptiveKController as JaxController
    from repro.comm import Participation as JaxParticipation

    jdata, tdata = linreg
    jkw, tkw = dict(aggregation=collective), dict(aggregation=collective)
    if participation is not None:
        tpart = Participation(**participation)
        if tpart.kind in ("bernoulli", "sampled"):
            _share_masks(monkeypatch, tpart, 4, rounds)
        jkw["participation"] = JaxParticipation(**participation)
        tkw["participation"] = tpart
    if adaptive is not None:
        jkw["adaptive_k"] = JaxController(**adaptive)
        tkw["adaptive_k"] = AdaptiveKController(**adaptive)
    jtrace, ttrace = trace or ((lambda s: s.worker_states.s_prev),) * 2
    jsim = JaxSim(jpipe.linreg_grad_fn(jdata), 4, 64, _cfg(kind, JaxConfig),
                  learning_rate=1e-2, **jkw)
    tsim = DistributedSim(linreg_grad_fn(tdata), 4, 64, _cfg(kind, SparsifierConfig),
                          learning_rate=1e-2, device="cpu", **tkw)
    return (jsim.run(jnp.zeros(64), rounds, trace_state_fn=jtrace),
            tsim.run(torch.zeros(64), rounds, trace_state_fn=ttrace))


@pytest.mark.parametrize("kind,schedule,collective", PART_CASES)
def test_participation_matches_jax(linreg, kind, schedule, collective, monkeypatch):
    """40 rounds under each schedule against the JAX simulator, with
    ``bernoulli`` and ``sampled`` sharing the port's masks: the masks of the
    first 5 rounds exact, the final theta to rtol 1e-4 as in
    ``test_linreg_matches_jax``, every worker's round counter exactly and
    its error to the same rtol; ``stale``'s pending buffer and countdown
    too."""
    (jfin, jmasks), (tfin, tmasks) = _pair_runs(
        linreg, kind, collective, monkeypatch, participation=SCHEDULES[schedule])
    np.testing.assert_array_equal(tmasks[:5].numpy(), np.asarray(jmasks)[:5])
    np.testing.assert_allclose(tfin.theta.numpy(), np.asarray(jfin.theta),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(tfin.worker_states.t.numpy(),
                                  np.asarray(jfin.worker_states.t))
    # eps with a floor of 1e-5 of its largest magnitude: DGC's reaches
    # ~40, and a coordinate near zero there keeps the absolute error
    jeps = np.asarray(jfin.worker_states.eps)
    np.testing.assert_allclose(tfin.worker_states.eps.numpy(), jeps, rtol=1e-4,
                               atol=1e-5 * np.abs(jeps).max())
    assert tfin.step == ROUNDS
    if schedule == "stale":
        np.testing.assert_array_equal(tfin.pending_age.numpy(),
                                      np.asarray(jfin.pending_age))
        np.testing.assert_allclose(tfin.pending.numpy(), np.asarray(jfin.pending),
                                   rtol=1e-4, atol=1e-6)
        assert int(tfin.pending_age.max()) > 0
    else:
        assert tfin.pending is None and jfin.pending is None
    if schedule == "sampled":
        # each worker's round counter counts only the rounds it was drawn
        assert int(tfin.worker_states.t.min()) < ROUNDS


ADAPTIVE = dict(budget=2.0, k_min=2, k_max=24)


@pytest.mark.parametrize("kind", ["topk", "regtopk"])
@pytest.mark.parametrize("collective", ["sparse_allgather", "dense_allreduce"])
def test_adaptive_k_matches_jax(linreg, kind, collective, monkeypatch):
    """40 rounds under the controller: the k trajectory exactly, the final
    ``err_ratio`` to rtol 1e-5 and theta to rtol 1e-4."""
    k_of = lambda s: s.ctrl.k  # noqa: E731
    (jfin, jk), (tfin, tk) = _pair_runs(linreg, kind, collective, monkeypatch,
                                         adaptive=ADAPTIVE, trace=(k_of, k_of))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    assert len(set(tk.tolist())) > 2  # the controller moved k
    np.testing.assert_allclose(float(tfin.ctrl.err_ratio), float(jfin.ctrl.err_ratio),
                               rtol=1e-5)
    np.testing.assert_allclose(tfin.theta.numpy(), np.asarray(jfin.theta),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("schedule", ["round_robin", "sampled"])
def test_adaptive_k_under_participation_matches_jax(linreg, schedule, monkeypatch):
    k_of = lambda s: s.ctrl.k  # noqa: E731
    (jfin, jk), (tfin, tk) = _pair_runs(
        linreg, "regtopk", "sparse_allgather", monkeypatch,
        participation=SCHEDULES[schedule], adaptive=ADAPTIVE, trace=(k_of, k_of))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_allclose(tfin.theta.numpy(), np.asarray(jfin.theta),
                               rtol=1e-4, atol=1e-5)


def _run(tdata, rounds=20, kind="regtopk", **kw):
    sim = DistributedSim(linreg_grad_fn(tdata), 4, 64, _cfg(kind, SparsifierConfig),
                         learning_rate=1e-2, device="cpu", **kw)
    return sim.run(torch.zeros(64), rounds,
                   trace_state_fn=lambda s: s.worker_states.s_prev)


def _states_equal(a, b):
    (fa, ta), (fb, tb) = a, b
    assert torch.equal(ta, tb)
    assert torch.equal(fa.theta, fb.theta) and torch.equal(fa.g_agg_prev, fb.g_agg_prev)
    for x, y in zip(fa.worker_states, fb.worker_states, strict=True):
        assert torch.equal(x, y)


@pytest.mark.parametrize("collective", ["sparse_allgather", "dense_allreduce"])
def test_off_switches_are_the_static_full_path_bit_for_bit(linreg, collective):
    """A full schedule (and a zero-rate bernoulli) is ``participation=None``;
    a controller pinned at the static k (k_min = k_max = 16, S = 0.25 of
    64) is ``adaptive_k=None``, in bits."""
    _, tdata = linreg
    base = _run(tdata, aggregation=collective)
    for part in (Participation("full"), Participation("bernoulli", drop_rate=0.0)):
        _states_equal(_run(tdata, aggregation=collective, participation=part), base)
    pinned = _run(tdata, aggregation=collective,
                  adaptive_k=AdaptiveKController(budget=1.0, k_min=16, k_max=16))
    _states_equal(pinned, base)
    assert int(pinned[0].ctrl.k) == 16


@pytest.mark.parametrize("extra", [
    dict(participation=Participation("round_robin", n_stragglers=1)),
    dict(participation=Participation("stale", n_stragglers=2, staleness=2)),
    dict(participation=Participation("sampled", n_sampled=3)),
    dict(adaptive_k=AdaptiveKController(**ADAPTIVE)),
])
def test_fastpath_on_equals_off_under_partial_rounds(linreg, extra):
    """Through the score kernel's wrapper (the plain chain on the CPU) and
    without it, the partial and adaptive rounds agree bit for bit."""
    _, tdata = linreg
    on = _run(tdata, aggregation="sparse_allgather", fastpath="on", **extra)
    off = _run(tdata, aggregation="sparse_allgather", fastpath="off", **extra)
    _states_equal(on, off)
    if "adaptive_k" in extra:
        assert torch.equal(on[0].ctrl.k, off[0].ctrl.k)


def test_sampled_idle_clients_are_untouched(linreg):
    """A ``sampled`` round touches only its cohort's state."""
    _, tdata = linreg
    part = Participation("sampled", n_sampled=2, seed=5)
    sim = DistributedSim(linreg_grad_fn(tdata), 4, 64, _cfg("regtopk", SparsifierConfig),
                         aggregation="sparse_allgather", participation=part,
                         device="cpu")
    st = sim.init(torch.zeros(64))
    for r in range(6):
        new, _ = sim.step_fn(st)
        cohort = part.round_participants(r, 4, device="cpu").tolist()
        idle = [w for w in range(4) if w not in cohort]
        for x, y in zip(st.worker_states, new.worker_states, strict=True):
            assert torch.equal(x[idle], y[idle])
        st = new


@pytest.mark.parametrize("codec", ["coo_fp32", "coo_q8"])
def test_wire_bytes_per_round_prices_partial_and_adaptive_rounds_as_jax(codec):
    from repro.comm import AdaptiveKController as JaxController
    from repro.comm import Participation as JaxParticipation

    for coll in ("sparse_allgather", "hierarchical", "dense_allreduce"):
        for spec in (dict(kind="round_robin", n_stragglers=1),
                     dict(kind="bernoulli", drop_rate=0.5),
                     dict(kind="sampled", n_sampled=2), None):
            for ctrl in (None, dict(budget=0.5, k_min=4, k_max=0.05)):
                jkw, tkw = {}, {}
                if spec:
                    jkw["participation"] = JaxParticipation(**spec)
                    tkw["participation"] = Participation(**spec)
                if ctrl:
                    jkw["adaptive_k"] = JaxController(**ctrl)
                    tkw["adaptive_k"] = AdaptiveKController(**ctrl)
                kw = dict(codec=codec, collective=coll, dp_shape=(2, 2))
                jsim = JaxSim(None, 4, 5000, JaxConfig(kind="regtopk", sparsity=0.01),
                              **kw, **jkw)
                tsim = _sim(length=5000, sparsifier_cfg=SparsifierConfig(sparsity=0.01),
                            **kw, **tkw)
                want, got = jsim.wire_bytes_per_round(), tsim.wire_bytes_per_round()
                assert (got.bytes_on_wire, got.n_messages, got.seconds) == (
                    want.bytes_on_wire, want.n_messages, want.seconds)


def test_stale_adaptive_run_continues_from_a_jax_state(linreg):
    """``convert.sim_state_from_jax`` carries the pending buffer, its
    countdown and the controller: 20 JAX rounds under ``stale`` and the
    controller, then 5 more in each stack, the k trajectory exactly."""
    from repro.comm import AdaptiveKController as JaxController
    from repro.comm import Participation as JaxParticipation

    jdata, tdata = linreg
    part = dict(kind="stale", n_stragglers=1, staleness=2, discount=0.5)
    kw = dict(learning_rate=1e-2, aggregation="sparse_allgather")
    jsim = JaxSim(jpipe.linreg_grad_fn(jdata), 4, 64, _cfg("regtopk", JaxConfig),
                  participation=JaxParticipation(**part),
                  adaptive_k=JaxController(**ADAPTIVE), **kw)
    tsim = DistributedSim(linreg_grad_fn(tdata), 4, 64, _cfg("regtopk", SparsifierConfig),
                          participation=Participation(**part),
                          adaptive_k=AdaptiveKController(**ADAPTIVE), device="cpu", **kw)
    st = jsim.init(jnp.zeros(64))
    for _ in range(20):
        st, _ = jsim.step_fn(st)
    tst = sim_state_from_jax(jax.tree.map(np.asarray, st), device="cpu")
    assert torch.equal(tst.pending_age, torch.from_numpy(np.array(st.pending_age)))
    for _ in range(5):
        st, jg = jsim.step_fn(st)
        tst, tg = tsim.step_fn(tst)
        assert int(tst.ctrl.k) == int(st.ctrl.k)
        np.testing.assert_array_equal(tst.pending_age.numpy(), np.asarray(st.pending_age))
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-6)
    got = sim_state_to_numpy(tst)
    np.testing.assert_allclose(got["pending"], np.asarray(st.pending), rtol=1e-5, atol=1e-7)
    assert int(got["ctrl"]["t"]) == 25
