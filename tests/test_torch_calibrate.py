"""The port's micro-calibration (``repro_torch.comm.calibrate``) and the
trainer's ``--calibrate`` and ``--replan-every``, on one process and
across two gloo ranks.

* ``fit_alpha_beta`` equals the JAX package's on the same ``Sample`` rows
  (``==`` on alpha and beta: the same numpy least squares and clamps),
  and refuses zero rows alike.
* In one process there is no process group, so no wire: ``calibrate``
  and ``calibrate_topo`` return the defaults with ``calibrated=False``,
  and the trainer's ``--calibrate`` prints that it skipped and keeps the
  defaults. That is the port's form of the JAX package's single-device
  fallback, and a known difference (ROADMAP §3): the JAX trainer on a
  host mesh of W devices probes them.
* Across two ranks (one spawn; process groups from a file under
  ``tmp_path``; every wait bounded): ``calibrate`` gives
  ``calibrated=True`` and one model on both ranks (rank 0's samples,
  broadcast), with samples whose message and byte counts are the JAX
  ``cost._pattern``'s; ``calibrate_topo`` on ``(pod, data) = (1, 2)``
  leaves ``pod`` at its defaults, uncalibrated; the trainer's
  ``--codec auto --collective auto --calibrate`` plans one plan on both
  ranks, the JAX ``build_plan``'s under the fitted model; and a
  ``--replan-every 1`` run of 3 steps (with ``--overlap buckets:2``, and
  again under ``--adaptive-k``) replans at every step boundary, with the
  picks, the controller's k and the params equal across the ranks in f32
  bits.

The rank body is a module-level function, and this file imports ``jax``
and ``repro`` only inside the tests, so a spawned rank loads no JAX.
"""
import contextlib
import io

import numpy as np
import pytest
import torch

from repro_torch.comm import calibrate as tcal
from repro_torch.comm.cost import AlphaBeta
from repro_torch.launch.mesh import DpGroups

LENGTHS = (256, 4096)
SMOKE = ["--smoke", "--seq", "16", "--device", "cpu", "--log-every", "1",
         "--codec", "auto", "--collective", "auto"]


def _rows(seed, alpha, beta, noise, n=8):
    rng = np.random.default_rng(seed)
    m = rng.integers(0, 30, n)
    b = rng.integers(0, 10_000_000, n)
    return [(int(mi), int(bi), float(mi * alpha + bi * beta + rng.normal(0, noise)))
            for mi, bi in zip(m, b, strict=True)]


@pytest.mark.parametrize("alpha,beta,noise", [
    (2e-5, 3e-10, 0.0), (1e-4, 1e-9, 1e-6), (1e-7, 2e-9, 1e-5),
    (5e-5, 1e-14, 1e-6), (0.0, 0.0, 0.0), (-1e-5, 1e-9, 0.0),
])
def test_fit_alpha_beta_matches_jax(alpha, beta, noise):
    from repro.comm import calibrate as jcal

    for seed in range(5):
        rows = _rows(seed, alpha, beta, noise)
        got = tcal.fit_alpha_beta([tcal.Sample("p", i, *r) for i, r in enumerate(rows)])
        want = jcal.fit_alpha_beta([jcal.Sample("p", i, *r) for i, r in enumerate(rows)])
        assert (got.alpha, got.beta) == (want.alpha, want.beta)
        assert got.alpha >= 1e-9 and got.beta >= 1e-14


def test_fit_alpha_beta_refuses_zero_rows_as_jax():
    from repro.comm import calibrate as jcal

    with pytest.raises(ValueError) as je:
        jcal.fit_alpha_beta([])
    with pytest.raises(ValueError) as te:
        tcal.fit_alpha_beta([])
    assert str(te.value) == str(je.value)


def test_one_process_has_no_wire_to_probe():
    from repro.comm import calibrate as jcal

    res = tcal.calibrate(device="cpu")
    assert (res.calibrated, res.model, res.samples) == (False, AlphaBeta(), ())
    topo = tcal.calibrate_topo(device="cpu")
    assert not topo.calibrated and topo.axes == ("data",)
    assert topo.topo.links == (AlphaBeta(),)
    for fn, jfn in ((tcal.calibrate, jcal.calibrate),
                    (tcal.calibrate_topo, jcal.calibrate_topo)):
        with pytest.raises(ValueError) as te:
            fn(dp_axes=("pod", "data"))
        with pytest.raises(ValueError) as je:
            jfn(dp_axes=("pod", "data"))
        assert str(te.value) == str(je.value)
    # a dp layout whose probed axes hold one worker has no wire either
    one = DpGroups(("pod", "data"), (1, 2), (None, None), 0)
    assert not tcal.calibrate(one, ("pod",), device="cpu").calibrated


def test_time_collective_refuses_other_probes_as_jax():
    groups = DpGroups(("data",), (2,), (None,), 0)
    with pytest.raises(ValueError, match="not implemented") as te:
        tcal.time_collective(groups, ("data",), 512, "hierarchical", device="cpu")
    assert "use 'dense_allreduce' or 'sparse_allgather'" in str(te.value)


@pytest.mark.parametrize("extra", [[], ["--link-topo", "data:2e-6,5e-12"]])
def test_trainer_calibrate_in_one_process_keeps_the_defaults(extra, capsys):
    """Known difference (ROADMAP §3): with W workers in one process there is
    no process group and no wire, so ``--calibrate`` skips and the comm
    line prices with the defaults; ``--link-topo`` wins, as in JAX."""
    from repro_torch.launch import train

    base = [*SMOKE, "--workers", "2", "--steps", "1", *extra]
    res = train.run(train.parse_args([*base, "--calibrate"]))
    out = capsys.readouterr().out
    ref = train.run(train.parse_args(base))
    ref_out = capsys.readouterr().out
    assert res.dist.link_model is None and res.dist.link_topo == ref.dist.link_topo
    comm = [ln for ln in out.splitlines() if ln.startswith("comm:")]
    assert comm == [ln for ln in ref_out.splitlines() if ln.startswith("comm:")]
    if extra:
        assert "--link-topo given; skipping --calibrate" in out
    else:
        assert ("calibration skipped (one process: no process group, so no wire "
                "to probe); using defaults") in out


def _rank(rank, world, store, out_dir):
    """One rank: the two calibrations and the two trainer runs; results
    (and rank 0's printed lines) saved to ``out_dir/rank{rank}.pt``."""
    import torch.distributed as dist

    from repro_torch.launch import mesh, train
    from repro_torch.tree import tree_items

    mesh.init_file_store(store, rank, world, "gloo")
    try:
        host = mesh.make_host_groups()
        out = {}
        res = tcal.calibrate(host, ("data",), LENGTHS, iters=2, device="cpu")
        out["calibrate"] = (res.calibrated, (res.model.alpha, res.model.beta),
                            [tuple(s.__dict__.values()) for s in res.samples])
        pod_data = DpGroups(("pod", "data"), (1, world), (None, dist.group.WORLD),
                            rank)
        topo = tcal.calibrate_topo(pod_data, ("pod", "data"), LENGTHS, iters=2,
                                   device="cpu")
        out["topo"] = (topo.calibrated, [c.calibrated for c in topo.per_axis],
                       [(lk.alpha, lk.beta) for lk in topo.topo.links])
        for name, flags in (
                ("auto", ["--steps", "2", "--calibrate"]),
                ("replan", ["--steps", "3", "--replan-every", "1", "--overlap",
                            "buckets:2"]),
                ("replan-adaptive", ["--steps", "3", "--replan-every", "1",
                                     "--adaptive-k", "1.0,0.001,0.012",
                                     "--fastpath", "on"])):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                run = train.run(train.parse_args([*SMOKE, *flags]), mesh=host)
            lm = run.dist.link_model
            out[name] = {
                "plan": [(path, p.codec, p.collective, p.fused)
                         for path, p in tree_items(run.plan)],
                "params": {path: x for path, x in tree_items(run.params)},
                "losses": run.losses,
                "model": None if lm is None else (lm.alpha, lm.beta),
                "stdout": buf.getvalue(),
                "ks": ([int(c.k) for _, c in tree_items(run.sp_state[1])]
                       if isinstance(run.sp_state, tuple) else None),
                "fused_rounds": run.counts.rounds,
            }
        torch.save(out, f"{out_dir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks_out(tmp_path_factory):
    from repro_torch.launch import mesh

    d = tmp_path_factory.mktemp("calibrate2")
    mesh.spawn(_rank, 2, (str(d / "store"), str(d)), timeout=120)
    return [torch.load(d / f"rank{r}.pt") for r in range(2)]


def test_calibrate_across_ranks_is_one_model(ranks_out):
    from repro.comm import cost as jcost

    (cal0, model0, samples0), (cal1, model1, samples1) = (
        r["calibrate"] for r in ranks_out)
    assert cal0 and cal1 and model0 == model1 and samples0 == samples1
    assert model0[0] >= 1e-9 and model0[1] >= 1e-14
    assert [s[:2] for s in samples0] == [
        (c, L) for c in ("dense_allreduce", "sparse_allgather") for L in LENGTHS]
    for coll, L, msgs, nbytes, secs in samples0:
        by, want_msgs = jcost._pattern(coll, L, 0.0 if coll == "dense_allreduce"
                                       else L * 4, [2], 4)
        assert (msgs, nbytes) == (want_msgs, int(np.ceil(by)))
        assert secs > 0
    refit = tcal.fit_alpha_beta([tcal.Sample(*s) for s in samples0])
    assert (refit.alpha, refit.beta) == model0


def test_calibrate_topo_leaves_a_size_one_axis_at_its_defaults(ranks_out):
    topo0, topo1 = (r["topo"] for r in ranks_out)
    assert topo0 == topo1
    calibrated, per_axis, links = topo0
    assert calibrated and per_axis == [False, True]
    assert links[0] == (AlphaBeta().alpha, AlphaBeta().beta)


def test_calibrated_auto_plan_is_one_plan_and_jax_s(ranks_out):
    """``--codec auto --collective auto --calibrate`` at two ranks: one
    plan on both ranks, the JAX ``build_plan``'s per-leaf picks under the
    model rank 0 fitted; params equal in bits across the ranks."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.core import SparsifierConfig as JaxConfig
    from repro.core import distributed as jd

    runs = [r["auto"] for r in ranks_out]
    assert runs[0]["plan"] == runs[1]["plan"] and runs[0]["model"] == runs[1]["model"]
    assert runs[0]["losses"] == runs[1]["losses"]
    for path, x in runs[0]["params"].items():
        assert torch.equal(x.view(torch.int32), runs[1]["params"][path].view(torch.int32))
    assert "calibrated alpha=" in runs[0]["stdout"] and runs[1]["stdout"] == ""

    class _Mesh:
        shape = {"data": 2}

    shapes = {path: tuple(x.shape) for path, x in runs[0]["params"].items()}
    jdist = jd.DistConfig(sparsifier=JaxConfig(kind="regtopk", sparsity=0.01),
                          codec="auto", collective="auto",
                          link_model=jd.comm.AlphaBeta(*runs[0]["model"]))
    jplan = jd.build_plan({p: jax.ShapeDtypeStruct(s, jnp.float32)
                           for p, s in shapes.items()},
                          {p: P() for p in shapes}, _Mesh(), 0.01, jdist)
    assert [(path, c, s) for path, c, s, _ in runs[0]["plan"]] == [
        (path, jplan[path].codec, jplan[path].collective) for path in shapes]


@pytest.mark.parametrize("case", ["replan", "replan-adaptive"])
def test_replan_every_step_keeps_the_ranks_in_step(ranks_out, case):
    """``--replan-every 1`` over 3 steps: a replan after steps 1 and 2 (not
    after the last), printed by rank 0 alone; the picks and the params
    equal across the ranks. Under ``--adaptive-k`` the replans score the
    controller's k (``k_overrides``), equal on both ranks, and the fused
    worker-rounds go on counting across the rebuilt steps."""
    runs = [r[case] for r in ranks_out]
    out = runs[0]["stdout"]
    assert "replan @step 1: alpha=" in out and "replan @step 2: alpha=" in out
    assert "replan @step 3" not in out and "replan:   " in out
    assert ("comm:   overlap " in out) == (case == "replan")
    assert runs[1]["stdout"] == ""
    assert runs[0]["plan"] == runs[1]["plan"] and runs[0]["ks"] == runs[1]["ks"]
    if case == "replan-adaptive":
        assert runs[0]["ks"] and runs[0]["fused_rounds"] > 0
    assert runs[0]["losses"] == runs[1]["losses"] and len(runs[0]["losses"]) == 3
    for path, x in runs[0]["params"].items():
        assert torch.equal(x.view(torch.int32), runs[1]["params"][path].view(torch.int32))
