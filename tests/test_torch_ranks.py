"""The trainer across ranks: one worker per rank over ``torch.distributed``
(gloo, the CPU), against the JAX package's per-worker round and the
port's one-card trainer.

* The per-rank round (``make_sparsify_aggregate(..., mesh=...)``), two
  rounds at N = 2 and 4 on a fused leaf of 3·8192+17 elements and a small
  one, against ``repro.core.distributed._spa_leaf`` under
  ``jax.vmap(axis_name="data")``: the JAX runtime's own per-worker round
  (fastpath off there: its fused path equals its dense path bit for bit,
  and its interpret-mode kernel would take a minute to compile). The
  aggregate and ``eps``, ``sent_idx``, ``sent_g``, ``sent_w`` in f32 bits,
  except where ``all_reduce`` sums more than two ranks in the backend's
  order (``dense_allreduce``, ``hierarchical``'s inner stage and kind
  "none" at N = 4): there the aggregate and ``sent_g`` to rtol 1e-6 with
  a floor of 1e-6 of the largest magnitude (kind "none" sums four dense
  gradients, which cancel to near zero at some coordinates), every rank
  holding the same bits.
* Partial rounds and the adaptive-k controller, the same way: a
  ``round_robin`` schedule dropping N/2 workers (fused leaf, and with
  ``coo_q8``, ``hierarchical`` and coordinate weighting), a ``bernoulli``
  one under ``dense_allreduce`` (the JAX side reading the port's masks,
  which torch draws where JAX draws with ``jax.random``), and the
  controller's k on the fused leaf, with kind "none" under both. The JAX
  side builds each round's context from the mask and folds the round into
  the controller with ``_ctrl_update``, as ``make_sparsify_aggregate``
  does; the controller's k must match exactly, its ``err_ratio`` to rtol
  1e-5. The one-card round of these cases (W = 4 on the card) is held
  against the same JAX rounds.
* Three steps of the tiny model of ``tests/test_torch_train.py`` at two
  ranks against the one-card ``--workers 2`` run (also under
  ``round_robin:1`` and under ``--adaptive-k``), and at four ranks with
  ``round_robin:2`` and ``--adaptive-k`` against ``--workers 4``: losses, params and
  each rank's state against its worker's to that file's tolerances (rtol
  1e-5 with a floor of 1e-5 of a leaf's largest magnitude: the CPU
  backward is not deterministic), and the ranks' params equal in bits.
* ``torchrun --standalone --nproc-per-node 2 -m repro_torch.launch.train
  --smoke --device cpu``: only rank 0 prints, and its losses, printed to
  4 places, are the one-card run's.

Ranks are spawned once per world size, every case of that size in the
one spawn; each process group starts from a file under ``tmp_path`` (no
fixed port), and every wait is bounded (120 s). The rank bodies are
module-level functions and this file imports ``jax`` and ``repro`` only
inside the tests, so a spawned rank loads no JAX.
"""
import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
SHAPES = {"big": (3 * 8192 + 17,), "small": (4, 33)}
SPARSITY, ROUNDS = 0.005, 2
# name -> (kind, codec, collective, weighting, the port's fastpath)
ROUND_CASES = {
    "coo_fp32": ("regtopk", "coo_fp32", "sparse_allgather", "worker", "on"),
    "idx_delta-hierarchical": ("regtopk", "coo_idx_delta", "hierarchical",
                               "worker", "off"),
    "q8-coordinate": ("regtopk", "coo_q8", "sparse_allgather", "coordinate",
                      "off"),
    "dense_allreduce": ("regtopk", "coo_fp32", "dense_allreduce", "worker",
                        "off"),
    "none": ("none", "coo_fp32", "sparse_allgather", "worker", "off"),
    "round_robin": ("regtopk", "coo_fp32", "sparse_allgather", "worker", "on"),
    "bernoulli-dense": ("regtopk", "coo_fp32", "dense_allreduce", "worker",
                        "off"),
    "round_robin-q8-coordinate": ("regtopk", "coo_q8", "hierarchical",
                                  "coordinate", "off"),
    "adaptive": ("regtopk", "coo_fp32", "sparse_allgather", "worker", "on"),
    "adaptive-round_robin-none": ("none", "coo_fp32", "sparse_allgather",
                                  "worker", "off"),
}
ADAPTIVE_SPEC = "0.5,0.001,0.012"


def _extras(name, n):
    """A round case's ``(participation spec, adaptive-k spec)``: the
    round_robin cases drop n/2 of the n workers; bernoulli drops half."""
    part = None
    if "round_robin" in name:
        part = f"round_robin:{n // 2}"
    elif "bernoulli" in name:
        part = "bernoulli:0.5,3"
    adaptive = ADAPTIVE_SPEC if name.startswith("adaptive") and "none" not in name else None
    return part, adaptive
TINY = dict(name="tiny", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
            head_dim=16, d_ff=128, vocab=256)
STEPS, LR, TRAIN_SPARSITY, RTOL = 3, 1e-3, 0.01, 1e-5
# name -> (world size, DistConfig fields) of the trainer runs; the spec
# strings are parsed in the rank (``_train``)
TRAIN_CASES = {
    "fastpath": (2, dict(fastpath="on")),
    "dense_allreduce": (2, dict(collective="dense_allreduce")),
    "round_robin": (2, dict(fastpath="on", participation="round_robin:1")),
    "adaptive": (2, dict(fastpath="on", adaptive_k="1.0,0.001,0.02")),
    "round_robin-4": (4, dict(participation="round_robin:2",
                              adaptive_k="1.0,0.001,0.02")),
}
AUTO_FLAGS = ["--smoke", "--steps", "2", "--seq", "16", "--fastpath", "auto",
              "--device", "cpu", "--log-every", "100"]


def _grads(n):
    """Each round's ``{leaf: [N, *shape]}`` gradients."""
    rng = np.random.default_rng(17 + n)
    return [{name: rng.standard_normal((n, *s)).astype(np.float32)
             for name, s in SHAPES.items()} for _ in range(ROUNDS)]


def _batches():
    rng = np.random.default_rng(11)
    return [{key: rng.integers(0, TINY["vocab"], (4, 16)) for key in
             ("tokens", "labels")} for _ in range(STEPS)]


def _dist(kind, codec, collective, weighting, fastpath, part=None,
          adaptive=None):
    from repro_torch.comm import parse_adaptive_k, parse_participation
    from repro_torch.core import distributed as td
    from repro_torch.core.sparsify import SparsifierConfig

    return td.DistConfig(
        sparsifier=SparsifierConfig(kind=kind, sparsity=SPARSITY, mu=1.0),
        codec=codec, collective=collective, weighting=weighting,
        fastpath=fastpath,
        participation=parse_participation(part) if part else None,
        adaptive_k=parse_adaptive_k(adaptive) if adaptive else None)


def _port_rounds(name, n, rank=None, mesh=None):
    """The port's ROUNDS rounds of a round case: one card with all n
    workers (``mesh=None``), or this rank's round: per round ``(agg,
    state, controller)``, with the kernel 1 launch count and fused flags."""
    from repro_torch.comm.fastpath import FastpathCounts
    from repro_torch.core import distributed as td

    dcfg = _dist(*ROUND_CASES[name], *_extras(name, n))
    plan = td.build_plan({k: torch.zeros(s) for k, s in SHAPES.items()},
                         SPARSITY, dcfg)
    counts = FastpathCounts()
    spa = td.make_sparsify_aggregate(plan, dcfg, n, counts, mesh)
    state = td.init_sparsifier_state(plan, n if mesh is None else 1, "cpu")
    ctrl = (td.init_controller_state(plan, dcfg, "cpu")
            if dcfg.adaptive_k is not None else None)
    rows = slice(None) if mesh is None else slice(rank, rank + 1)
    rounds = []
    for g in _grads(n):
        grads = {k: torch.from_numpy(x[rows]) for k, x in g.items()}
        if ctrl is None:
            agg, state = spa(grads, state)
        else:
            agg, state, ctrl = spa(grads, state, ctrl)
        rounds.append((agg, state, ctrl))
    return rounds, counts.rounds, {k: p.fused for k, p in plan.items()}


def _train(mesh=None, workers=2, participation=None, adaptive_k=None,
           **fields):
    """Three steps of the tiny model: (losses, params, sparsifier state);
    under ``adaptive_k`` the state is the pair (compact, controller)."""
    from repro_torch.comm import parse_adaptive_k, parse_participation
    from repro_torch.core import distributed as td
    from repro_torch.core.sparsify import SparsifierConfig
    from repro_torch.models import lm
    from repro_torch.models.config import ModelConfig
    from repro_torch.optim import OptConfig, make_optimizer

    cfg = ModelConfig(**TINY)
    dist = td.DistConfig(
        sparsifier=SparsifierConfig(kind="regtopk", sparsity=TRAIN_SPARSITY),
        optimizer=OptConfig(kind="adam", learning_rate=LR),
        participation=participation and parse_participation(participation),
        adaptive_k=adaptive_k and parse_adaptive_k(adaptive_k), **fields)
    params = lm.init(cfg, seed=0, device="cpu")
    plan = td.build_plan(params, TRAIN_SPARSITY, dist)
    step = td.make_train_step(cfg, dist, plan, workers, mesh=mesh)
    opt_state = make_optimizer(dist.optimizer).init(params)
    sp = td.init_sparsifier_state(plan, 1 if mesh else workers, "cpu")
    if adaptive_k:
        sp = (sp, td.init_controller_state(plan, dist, "cpu"))
    losses = []
    for b in _batches():
        batch = {key: torch.from_numpy(v).long() for key, v in b.items()}
        params, opt_state, sp, m = step(params, opt_state, sp, batch)
        losses.append(float(m["loss"]))
    return losses, params, sp


def _rank(rank, world, store, out_dir):
    """One rank: every round case and every trainer run of this world
    size; results saved to ``out_dir/rank{rank}.pt``."""
    import torch.distributed as dist

    from repro_torch.launch import mesh, train
    from repro_torch.tree import tree_leaves

    mesh.init_file_store(store, rank, world, "gloo")
    try:
        host = mesh.make_host_groups()
        out = {"rounds": {}, "train": {}}
        for name in ROUND_CASES:
            out["rounds"][name] = _port_rounds(name, world, rank, host)
        for name, (size, fields) in TRAIN_CASES.items():
            if size == world:
                out["train"][name] = _train(host, world, **fields)
        if world == 2:
            res = train.run(train.parse_args(AUTO_FLAGS), mesh=host)
            out["auto"] = (res.losses,
                           [p.fused for p in tree_leaves(res.plan)])
        torch.save(out, f"{out_dir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks_out(tmp_path_factory):
    """World size -> every rank's results, one spawn per size."""
    from repro_torch.comm.controller import ControllerState
    from repro_torch.core.compact import CompactState
    from repro_torch.launch import mesh

    out = {}
    for n in (2, 4):
        d = tmp_path_factory.mktemp(f"ranks{n}")
        mesh.spawn(_rank, n, (str(d / "store"), str(d)), timeout=120)
        with torch.serialization.safe_globals([CompactState, ControllerState]):
            out[n] = [torch.load(d / f"rank{r}.pt") for r in range(n)]
    return out


def _jax_rounds(n, name):
    """The JAX runtime's per-worker round (``_spa_leaf``) for the N
    workers of round case ``name`` under ``jax.vmap(axis_name="data")``,
    ROUNDS rounds, as ``make_sparsify_aggregate`` runs it: per round
    ``{leaf: (agg [N, *shape], state with a leading [N] axis)}`` and the
    controller tree (or None). A participation case builds the round's
    context from the mask, a ``round_robin`` mask from the JAX schedule and
    a ``bernoulli`` one from the port's (torch cannot reproduce
    ``jax.random``); an adaptive case sends the controller's k and folds
    the round in with ``_ctrl_update``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.comm import codec as jcodec
    from repro.comm import parse_adaptive_k, parse_participation, worker_index
    from repro.core import compact as jc
    from repro.core import distributed as jd
    from repro.core.selectors import sparsity_to_k
    from repro.core.sparsify import SparsifierConfig
    from repro_torch.comm import participation as tpart

    kind, codec, collective, weighting, _ = ROUND_CASES[name]
    pspec, aspec = _extras(name, n)
    part = pspec and parse_participation(pspec)
    ctrl_cfg = aspec and parse_adaptive_k(aspec)
    omega = 1.0 / n if not part else part.effective_omega(n)
    scfg = SparsifierConfig(kind=kind, sparsity=SPARSITY, mu=1.0, omega=omega)

    def k_of(length):
        return ctrl_cfg.bounds(length)[1] if ctrl_cfg else sparsity_to_k(length, SPARSITY)

    plans = {leaf: jd.LeafPlan(s, s, int(np.prod(s)), k_of(int(np.prod(s))), P(None))
             for leaf, s in SHAPES.items()}
    if part and part.kind == "bernoulli":
        table = jnp.asarray(np.stack([
            tpart.parse_participation(pspec).round_mask(r, n, device="cpu").numpy()
            for r in range(ROUNDS)]))
        round_mask = lambda r: table[r]  # noqa: E731
    elif part:
        round_mask = lambda r: part.round_mask(r, n)  # noqa: E731

    def init(p):
        st = jc.compact_init(p.local_len, p.k)
        one = jc.CompactState(
            eps=st.eps.reshape((1,) + p.local_shape),
            sent_vals=st.sent_vals[None, None], sent_g=st.sent_g[None, None],
            sent_idx=st.sent_idx[None, None], sent_w=st.sent_w[None, None],
            t=st.t[None])
        return jax.tree.map(lambda x: jnp.stack([x] * n), one)

    def worker(g, st, ctrl):
        part_ctx = None
        if part:
            pmask = round_mask(st["big"].t[0])
            part_ctx = (pmask[worker_index(("data",), (n,))],
                        1.0 / jnp.maximum(pmask.sum(), 1.0))
        out = {leaf: jd._spa_leaf(g[leaf], st[leaf], p, scfg,
                                  jcodec.get_codec(codec), collective, ("data",),
                                  part_ctx, False,
                                  None if ctrl is None else ctrl[leaf].k,
                                  weighting=weighting)
               for leaf, p in plans.items()}
        new_ctrl = None if ctrl is None else {
            leaf: jd._ctrl_update(ctrl_cfg, ctrl[leaf], out[leaf][1], out[leaf][0],
                                  p, ("data",), (), *ctrl_cfg.bounds(p.local_len))
            for leaf, p in plans.items()}
        return out, new_ctrl

    step = jax.jit(jax.vmap(worker, axis_name="data", in_axes=(0, 0, None)))
    state = {leaf: init(p) for leaf, p in plans.items()}
    ctrl = None if not ctrl_cfg else {
        leaf: ctrl_cfg.init(sparsity_to_k(p.local_len, SPARSITY),
                            *ctrl_cfg.bounds(p.local_len))
        for leaf, p in plans.items()}
    out = []
    for g in _grads(n):
        res, ctrl = step({leaf: jnp.asarray(x[:, None]) for leaf, x in g.items()},
                         state, ctrl)
        ctrl = None if ctrl is None else jax.tree.map(lambda x: x[0], ctrl)
        state = {leaf: r[1] for leaf, r in res.items()}
        out.append((res, ctrl))
    return out


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def _check_round(case, w, row, agg, st, ctrl, jres, jctrl, exact, msg):
    """Worker ``w``'s round (its state at ``row``: 0 on its own rank, w on
    one card) against the JAX package's: see the module docstring."""
    kind = ROUND_CASES[case][0]
    for name, s in SHAPES.items():
        jagg, jst = jres[name]
        assert agg[name].shape == s
        assert np.count_nonzero(agg[name].numpy()) > 0
        pairs = {"agg": (agg[name].numpy(), jagg[w])}
        if kind != "none":
            pairs.update(
                {f: (getattr(st[name], f)[row].numpy(),
                     np.asarray(getattr(jst, f)[w]).reshape(-1))
                 for f in ("eps", "sent_g", "sent_w")})
            np.testing.assert_array_equal(
                st[name].sent_idx[row].numpy(),
                np.asarray(jst.sent_idx[w]).reshape(-1), err_msg=f"{msg} {name}")
        np.testing.assert_array_equal(
            st[name].t[row:row + 1].numpy(), np.asarray(jst.t[w]), err_msg=msg)
        for f, (got, exp) in pairs.items():
            if exact or f in ("eps", "sent_w"):
                np.testing.assert_array_equal(
                    _bits(got), _bits(np.reshape(exp, got.shape)),
                    err_msg=f"{msg} {name} {f}")
            else:  # a floor where four summands cancel
                np.testing.assert_allclose(
                    got, np.reshape(exp, got.shape), rtol=1e-6,
                    atol=1e-6 * np.abs(exp).max(), err_msg=f"{msg} {name} {f}")
        if jctrl is not None:
            # the controller's k exactly; err_ratio reads the workers'
            # summed norms (four in the backend's order at N = 4)
            c, jc = ctrl[name], jctrl[name]
            assert (int(c.k), int(c.t)) == (int(jc.k), int(jc.t)), f"{msg} {name}"
            np.testing.assert_allclose(float(c.err_ratio), float(jc.err_ratio),
                                       rtol=1e-5, err_msg=f"{msg} {name}")


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("case", list(ROUND_CASES))
def test_rank_round_matches_jax_spa_leaf(ranks_out, case, n):
    kind, codec, collective, weighting, fastpath = ROUND_CASES[case]
    want = _jax_rounds(n, case)
    # all_reduce over more than two ranks sums in the backend's order
    exact = n <= 2 or collective == "sparse_allgather" and kind != "none"
    for r in range(n):
        rounds, fused_rounds, fused = ranks_out[n][r]["rounds"][case]
        if fastpath == "on":
            assert fused["big"] and fused_rounds == ROUNDS * sum(fused.values())
        for t, ((agg, st, ctrl), (jres, jctrl)) in enumerate(
                zip(rounds, want, strict=True)):
            msg = f"{case} rank {r} round {t}"
            first = ranks_out[n][0]["rounds"][case][0][t][0]
            for name in SHAPES:
                np.testing.assert_array_equal(_bits(agg[name]), _bits(first[name]),
                                              err_msg=f"{msg}: rank vs rank 0")
            _check_round(case, r, 0, agg, st, ctrl, jres, jctrl, exact, msg)


PARTIAL_CASES = [c for c in ROUND_CASES if _extras(c, 4) != (None, None)]


@pytest.mark.parametrize("case", PARTIAL_CASES)
def test_one_card_partial_round_matches_jax_spa_leaf(case):
    """The one-card round (W = 4 on this card) of every participation and
    adaptive case against the same JAX rounds: bits where the reduction is
    the worker-ordered scatter-add (``sparse_allgather``), rtol 1e-6 with
    the floor where XLA's ``psum`` sums four workers in its own order."""
    kind, codec, collective, weighting, fastpath = ROUND_CASES[case]
    n = 4
    want = _jax_rounds(n, case)
    rounds, fused_rounds, fused = _port_rounds(case, n)
    if fastpath == "on":
        assert fused["big"] and fused_rounds == n * ROUNDS * sum(fused.values())
    exact = collective == "sparse_allgather" and kind != "none"
    for t, ((agg, st, ctrl), (jres, jctrl)) in enumerate(zip(rounds, want, strict=True)):
        for w in range(n):
            _check_round(case, w, w, agg, st, ctrl, jres, jctrl, exact,
                         f"{case} worker {w} round {t}")


def _close(got, want, msg):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max(), err_msg=msg)


def _trainer_matches_one_card(ranks_out, case):
    """Every rank's run of a trainer case against the one-card run with
    as many workers: losses and params to the file's tolerances, params
    equal in bits across ranks, each rank's state against its worker's
    (and, under adaptive k, the controller's k on every rank exactly)."""
    from repro_torch.tree import tree_items

    world, fields = TRAIN_CASES[case]
    losses, params, sp = _train(workers=world, **fields)
    adaptive = "adaptive_k" in fields
    runs = [ranks_out[world][r]["train"][case] for r in range(world)]
    for r, (rlosses, rparams, rsp) in enumerate(runs):
        assert rlosses == runs[0][0]
        np.testing.assert_allclose(rlosses, losses, rtol=RTOL)
        for (path, got), (_, first), (_, want) in zip(
                tree_items(rparams), tree_items(runs[0][1]), tree_items(params),
                strict=True):
            np.testing.assert_array_equal(_bits(got), _bits(first),
                                          err_msg=f"{path}: rank {r} vs rank 0")
            _close(got.numpy(), want.numpy(), path)
        cstate, ostate = (rsp[0], sp[0]) if adaptive else (rsp, sp)
        if adaptive:
            assert ([int(c.k) for _, c in tree_items(rsp[1])]
                    == [int(c.k) for _, c in tree_items(sp[1])])
        for (path, got), (_, want) in zip(tree_items(cstate), tree_items(ostate),
                                          strict=True):
            np.testing.assert_array_equal(got.t.numpy(), want.t[r:r + 1].numpy())
            _close(got.eps.numpy(), want.eps[r:r + 1].numpy(), f"{path}.eps")
            # sent sets by index: scores one ulp apart may list in either order
            np.testing.assert_array_equal(
                np.sort(got.sent_idx.numpy()[0]), np.sort(want.sent_idx.numpy()[r]),
                err_msg=path)


@pytest.mark.parametrize("case", [c for c, (n, _) in TRAIN_CASES.items() if n == 2])
def test_two_rank_trainer_matches_one_card(ranks_out, case):
    _trainer_matches_one_card(ranks_out, case)


@pytest.mark.parametrize("case", [c for c, (n, _) in TRAIN_CASES.items() if n == 4])
def test_four_rank_trainer_matches_one_card(ranks_out, case):
    """``--participation round_robin:2`` with ``--adaptive-k`` at four
    ranks against the one-card ``--workers 4`` run."""
    _trainer_matches_one_card(ranks_out, case)


def test_fastpath_auto_across_ranks_builds_one_plan(ranks_out):
    """``--fastpath auto`` across ranks: rank 0's table is broadcast, every
    rank builds the same plan (on the CPU auto fuses nothing), and the run
    is the one-card run."""
    from repro_torch.launch import train

    (l0, plan0), (l1, plan1) = (ranks_out[2][r]["auto"] for r in range(2))
    assert plan0 == plan1 and not any(plan0)
    assert l0 == l1
    one_card = train.run(train.parse_args([*AUTO_FLAGS, "--workers", "2"]))
    np.testing.assert_allclose(l0, one_card.losses, rtol=RTOL)


def test_torchrun_two_ranks_on_the_cpu():
    """The CLI under ``torchrun``: two ranks, only rank 0 prints, and the
    logged losses are the one-card ``--workers 2`` run's."""
    from repro_torch.launch import train

    flags = ["--smoke", "--steps", "3", "--seq", "16", "--fastpath", "on",
             "--log-every", "1"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train", *flags,
         "--device", "cpu"],
        capture_output=True, text=True, env=env, timeout=120, cwd=ROOT,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.count("comm: codec=coo_fp32") == 1
    assert "ranks: 2 over gloo, dp axes {'data': 2}" in out.stdout
    logged = [float(x) for x in re.findall(r"^step +\d+ loss (\S+)", out.stdout,
                                           re.M)]
    one_card = train.run(train.parse_args([*flags, "--workers", "2",
                                            "--device", "cpu"])).losses
    # printed to 4 places: half a unit of the print, and rtol 1e-5 (the
    # CPU backward is not deterministic)
    assert len(logged) == len(one_card)
    for got, want in zip(logged, one_card, strict=True):
        assert abs(got - want) <= 5e-5 + RTOL * abs(want)


def test_ranks_refuse_the_stale_schedule():
    """Bounded-staleness delivery needs the simulator's pending buffer: the
    round refuses it, on one card and across ranks, as the JAX runtime
    does."""
    from repro_torch.comm import parse_participation
    from repro_torch.core import distributed as td
    from repro_torch.launch.mesh import DpGroups

    dcfg = dataclasses.replace(_dist(*ROUND_CASES["coo_fp32"]), fastpath="off",
                               participation=parse_participation("stale:1"))
    plan = td.build_plan({"w": torch.zeros(8)}, SPARSITY, dcfg)
    for mesh in (None, DpGroups(("data",), (4,), (None,), 0)):
        with pytest.raises(ValueError, match="simulator-only"):
            td.make_sparsify_aggregate(plan, dcfg, 4, mesh=mesh)


def test_trainer_checks_workers_against_the_layout():
    """Across ranks W is the number of ranks in the dp layout."""
    from repro_torch.core import distributed as td
    from repro_torch.launch.mesh import DpGroups

    dcfg = dataclasses.replace(_dist(*ROUND_CASES["coo_fp32"]), fastpath="off")
    plan = td.build_plan({"w": torch.zeros(8)}, SPARSITY, dcfg)
    with pytest.raises(ValueError, match="W is the number of ranks"):
        td.make_sparsify_aggregate(
            plan, dcfg, 4, mesh=DpGroups(("pod", "data"), (2, 1), (None, None), 0))


def _failing_rank(rank, world):
    if rank == 1:
        raise ValueError("rank one fails")


def test_spawn_names_each_failed_ranks_exception():
    """A rank that raises fails the spawn, and the error names that rank's
    exception (its peers, in a real run, only see a collective fail)."""
    from repro_torch.launch import mesh

    with pytest.raises(RuntimeError, match=r"\{1: 1\}\n  rank 1 raised "
                       r"ValueError: rank one fails"):
        mesh.spawn(_failing_rank, 2, timeout=120)
