"""The trainer on a ``(data, model)`` mesh: one RegTop-k round per
(worker, model shard), against the JAX package's jitted trainer on the
same mesh.

The JAX trainer (``repro.core.distributed.assemble`` and
``jax.jit(train_step)``, as ``repro.launch.train`` runs it) takes three
steps per case in one subprocess for the whole module, under
``XLA_FLAGS=--xla_force_host_platform_device_count=8`` with meshes of Auto
axes (``repro.compat.make_mesh`` gives Explicit axes, which its
``with_sharding_constraint`` refuses on jax 0.9), and writes ``npz``
files under ``tmp_path``: the initial weights, the losses, the final
weights, the sparsifier state (``eps [W, *shape]``, ``sent_* [W, M,
k]``) and the controller state. The cases: the tiny dense model of
``tests/test_torch_train.py`` at ``(2, 2)`` and ``(1, 4)``,
deepseek-moe-16b's smoke variant under ``moe_parallelism="expert"`` at
``(2, 2)``, mamba2-780m's smoke variant at ``(2, 2)``, and the dense model
at ``(2, 2)`` with ``--adaptive-k`` and with ``dense_allreduce`` under
coordinate weighting.

The port runs each case from the JAX weights on one card (``mesh=None``:
W = devices / M workers, W x M rows a leaf; the dense case with the
fastpath off and on, which must agree in f32 bits) and across 4 gloo
ranks (one spawn, a file store under ``tmp_path``, every wait <= 120 s;
``launch.mesh.make_host_groups(model=M)``). Across the ranks every
case is tensor parallel (``models.tensor_parallel``; the MoE case's
experts split in the expert layout, the SSM case's mixer on its channels
and heads): each rank holds, computes and updates its blocks of the
split leaves (``nn.sharding.shard_params``), as GSPMD partitions the JAX
trainer. Each must match the JAX run:
losses and parameters to rtol 1e-5 with a floor of 1e-5 of a leaf's
largest magnitude, ``eps`` the same (1e-4 on the SSD's ``A_log`` and
``dt_bias``, whose gradients agree to that at one shard already,
``tests/test_torch_model.py``), ``sent_idx`` per (worker, shard) as
sets (two scores one ulp apart may list in either order), round counters
exactly, and the controller's per-leaf k exactly and its floats to rtol
1e-5. On one card the port's forward is whole where GSPMD partitions
JAX's; across ranks the row-parallel sums are the gloo all-reduce's
where JAX's are XLA's. Either way the gradients differ in their last bits, and the
losses are not compared in bits. Across the ranks a tensor-parallel rank
must hold exactly its blocks of the split leaves, each whole leaf must
be equal in bits on every rank, and the gathered parameters too.

Also: a 4-rank ``--model-parallel 2`` checkpoint resumes in one process,
the trainer's CLI at ``--workers 4 --model-parallel 2`` prints the losses
of ``run(args)``, and the layouts it cannot build are refused before
anything is allocated. This file imports ``jax`` only inside the tests
and the subprocess, so a spawned rank loads no JAX.
"""
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import _torch_cores  # noqa: F401  (this worker's share of the cores)

ROOT = Path(__file__).resolve().parents[1]
TINY = dict(name="tiny", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
            head_dim=16, d_ff=128, vocab=256)
SPARSITY, LR, STEPS, RTOL = 0.01, 1e-3, 3, 1e-5
B, S = 4, 16
ADAPTIVE = (1.0, 0.001, 0.02)
# the error state of the SSD's A_log and dt_bias leaves: their gradients
# agree to rtol 1e-4 (tests/test_torch_model.py, tests/test_torch_train.py)
SSD_DECAY_RTOL = 1e-4
# name -> (config, (data, model), DistConfig fields beside the defaults)
CASES = {
    "dense-2x2": ("tiny", (2, 2), {}),
    "dense-1x4": ("tiny", (1, 4), {}),
    "moe-expert-2x2": ("deepseek-moe-16b", (2, 2), {}),
    "ssm-2x2": ("mamba2-780m", (2, 2), {}),
    "adaptive-2x2": ("tiny", (2, 2), {"adaptive_k": ADAPTIVE}),
    "coord-dense-2x2": ("tiny", (2, 2), {"collective": "dense_allreduce",
                                          "weighting": "coordinate"}),
}
CKPT_FLAGS = ["--smoke", "--seq", "16", "--global-batch", "4", "--device",
              "cpu", "--log-every", "100", "--workers", "4",
              "--model-parallel", "2", "--fastpath", "on"]
CALIBRATE_FLAGS = ["--codec", "auto", "--collective", "auto", "--calibrate",
                   "--replan-every", "1"]


def _cfg(pkg, name):
    """The case's config from ``pkg`` (``repro`` or ``repro_torch``)."""
    import importlib

    mc = importlib.import_module(f"{pkg}.models.config")
    if name == "tiny":
        return mc.ModelConfig(family="dense", remat=False, **TINY)
    cfg = importlib.import_module(f"{pkg}.configs").get_config(name).smoke_variant()
    return cfg.replace(moe_parallelism="expert") if cfg.is_moe else cfg


def _batches(cfg_vocab, seed):
    rng = np.random.default_rng(seed)
    return [{key: rng.integers(0, cfg_vocab, (B, S)).astype(np.int32)
             for key in ("tokens", "labels")} for _ in range(STEPS)]


def _flatten(tree, prefix="", out=None):
    """``{path: numpy}`` of a tree of dicts and NamedTuples (``:field``)."""
    out = {} if out is None else out
    if isinstance(tree, dict):
        for key in sorted(tree):
            _flatten(tree[key], f"{prefix}.{key}" if prefix else key, out)
    elif hasattr(tree, "_fields"):
        for name in tree._fields:
            _flatten(getattr(tree, name), f"{prefix}:{name}", out)
    else:
        out[prefix] = np.asarray(tree)
    return out


def _nest(flat):
    """``{dotted path: array}`` as nested dicts."""
    out = {}
    for path, x in flat.items():
        d = out
        *head, last = path.split(".")
        for key in head:
            d = d.setdefault(key, {})
        d[last] = x
    return out


# ---------------------------------------------------------------------------
# the JAX side, in a subprocess of 8 host devices
# ---------------------------------------------------------------------------
def _jax_case(name, out_dir):
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType

    from repro import comm
    from repro.core import distributed as jd
    from repro.core.sparsify import SparsifierConfig
    from repro.models import get_family
    from repro.optim import OptConfig, make_optimizer

    arch, (W, M), fields = CASES[name]
    cfg = _cfg("repro", arch)
    mesh = jax.make_mesh((W, M), ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto),
                         devices=jax.devices()[:W * M])
    fields = dict(fields)
    if "adaptive_k" in fields:
        budget, lo, hi = fields["adaptive_k"]
        fields["adaptive_k"] = comm.AdaptiveKController(budget, k_min=lo,
                                                        k_max=hi)
    dist = jd.DistConfig(
        sparsifier=SparsifierConfig(kind="regtopk", sparsity=SPARSITY),
        optimizer=OptConfig(kind="adam", learning_rate=LR),
        dp_axes=("data",), **fields)
    mod = get_family(cfg)
    asm = jd.assemble(mod, cfg, dist, mesh)
    params, _ = mod.init(jax.random.PRNGKey(0), cfg)
    p0 = _flatten(jax.tree.map(np.asarray, params))
    opt_state = make_optimizer(dist.optimizer).init(params)
    sp, _ = jd.init_sparsifier_state(asm.plan, W, mesh, ("data",), jnp.float32)
    if dist.adaptive_k is not None:
        sp = (sp, jd.init_controller_state(asm.plan, dist)[0])
    step = jax.jit(asm.train_step)
    losses = []
    with mesh:
        for b in _batches(cfg.vocab, 7):
            params, opt_state, sp, m = step(params, opt_state, sp,
                                            jax.tree.map(jnp.asarray, b))
            losses.append(float(m["loss"]))
    cp, ctrl = sp if isinstance(sp, tuple) else (sp, None)
    np.savez(f"{out_dir}/{name}.npz", losses=np.array(losses),
             **{f"p0/{k}": v for k, v in p0.items()},
             **{f"params/{k}": v for k, v in
                _flatten(jax.tree.map(np.asarray, params)).items()},
             **{f"state/{k}": v for k, v in
                _flatten(jax.tree.map(np.asarray, cp)).items()},
             **({} if ctrl is None else {f"ctrl/{k}": v for k, v in _flatten(
                 jax.tree.map(np.asarray, ctrl)).items()}))


def _jax_main(out_dir):
    for name in CASES:
        _jax_case(name, out_dir)


def _section(run, prefix):
    """The arrays of one tree of a case's ``npz``, by path."""
    return {k[len(prefix) + 1:]: v for k, v in run.items()
            if k.startswith(prefix + "/")}


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_mp")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    res = subprocess.run([sys.executable, __file__, str(out)], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    return {name: dict(np.load(out / f"{name}.npz")) for name in CASES}


# ---------------------------------------------------------------------------
# the port
# ---------------------------------------------------------------------------
def _dist(fields, fastpath="off"):
    from repro_torch.comm.controller import AdaptiveKController
    from repro_torch.core import distributed as td
    from repro_torch.core.sparsify import SparsifierConfig
    from repro_torch.optim import OptConfig

    fields = dict(fields)
    if "adaptive_k" in fields:
        budget, lo, hi = fields["adaptive_k"]
        fields["adaptive_k"] = AdaptiveKController(budget, k_min=lo, k_max=hi)
    return td.DistConfig(
        sparsifier=SparsifierConfig(kind="regtopk", sparsity=SPARSITY),
        optimizer=OptConfig(kind="adam", learning_rate=LR), fastpath=fastpath,
        **fields)


def _port_run(name, p0, mesh=None, fastpath="off", blocks=None):
    """Three steps of case ``name`` from the weights ``p0`` ({path:
    numpy}): on one card, or this rank's of ``mesh`` (for a tensor-
    parallel case from its blocks of ``p0``, which it puts in the dict
    ``blocks`` when given). Returns (losses, params (whole, gathered over
    the model group), the whole state in the JAX layout (gathered across
    ranks), the controller tree or None, plan)."""
    from repro_torch import convert
    from repro_torch.core import distributed as td
    from repro_torch.launch import train
    from repro_torch.models import param_axes
    from repro_torch.nn.sharding import shard_params, unshard_params
    from repro_torch.optim import make_optimizer
    from repro_torch.tree import tree_map

    arch, (W, M), fields = CASES[name]
    cfg = _cfg("repro_torch", arch)
    dist = _dist(fields, fastpath)
    params = convert.params_from_jax(_nest(p0), device="cpu")
    plan = td.build_plan(params, SPARSITY, dist, axes=param_axes(cfg),
                         mesh={"data": W, "model": M})
    specs = tree_map(lambda p: p.spec, plan)
    shard = None if mesh is None else td.model_shard(
        cfg, plan, mesh.model_group, mesh.shard)
    if shard is not None:
        params = shard_params(params, specs, mesh.shard, M)
    step = td.make_train_step(cfg, dist, plan, W, mesh=mesh)
    opt_state = make_optimizer(dist.optimizer).init(params)
    sp = td.init_sparsifier_state(plan, W if mesh is None else 1, "cpu",
                                  shards=None if mesh is None else 1)
    if dist.adaptive_k is not None:
        sp = (sp, td.init_controller_state(plan, dist, "cpu"))
    losses = []
    for b in _batches(cfg.vocab, 7):
        batch = {k: torch.from_numpy(v).long() for k, v in b.items()}
        params, opt_state, sp, m = step(params, opt_state, sp, batch)
        losses.append(float(m["loss"]))
    cp, ctrl = sp if isinstance(sp, tuple) else (sp, None)
    whole = train._all_workers(cp, mesh)
    if shard is not None:
        if blocks is not None:
            blocks.update(params=params, split=shard.split)
        params = unshard_params(params, specs, mesh.model_group, M)
    return losses, params, convert.trainer_state_to_jax(whole, plan), ctrl, plan


def _close(got, want, msg, rtol=RTOL):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=rtol,
                               atol=rtol * np.abs(want).max(), err_msg=msg)


def _matches_jax(run, jax_run, name):
    from repro_torch.tree import tree_items

    losses, params, state, ctrl, plan = run
    np.testing.assert_allclose(losses, jax_run["losses"], rtol=RTOL,
                               err_msg=name)
    jparams = _section(jax_run, "params")
    for path, leaf in tree_items(params):
        _close(leaf.numpy(), jparams[path], f"{name} {path}")
    jstate = _section(jax_run, "state")
    _, (W, M), _ = CASES[name]
    for path, st in tree_items(state):
        where = f"{name} {path}"
        assert tuple(st.sent_idx.shape[:2]) == (W, M), where
        np.testing.assert_array_equal(st.t.numpy(), jstate[f"{path}:t"],
                                      err_msg=where)
        # the SSD's decay leaves carry their gradients' float32 spread
        # into the error they keep, as at one shard (SSD_DECAY_RTOL)
        _close(st.eps.numpy(), jstate[f"{path}:eps"], where,
               SSD_DECAY_RTOL if path.endswith(("mixer.A_log", "mixer.dt_bias"))
               else RTOL)
        idx, jidx = st.sent_idx.numpy(), jstate[f"{path}:sent_idx"]
        for w in range(W):
            for m in range(M):
                assert sorted(idx[w, m]) == sorted(jidx[w, m]), (where, w, m)
    if ctrl is not None:
        jctrl = _section(jax_run, "ctrl")
        for path, c in tree_items(ctrl):
            where = f"{name} {path}"
            assert int(c.k) == int(jctrl[f"{path}:k"]), where
            assert int(c.t) == int(jctrl[f"{path}:t"]), where
            np.testing.assert_allclose(float(c.err_ratio),
                                       float(jctrl[f"{path}:err_ratio"]),
                                       rtol=RTOL, err_msg=where)


@pytest.mark.parametrize("name", list(CASES))
def test_one_card_matches_jax(jax_runs, name):
    run = _port_run(name, _section(jax_runs[name], "p0"))
    _matches_jax(run, jax_runs[name], name)
    plan = run[4]
    from repro_torch.core import distributed as td
    from repro_torch.tree import tree_leaves

    assert all(p.shards == CASES[name][1][1] for p in tree_leaves(plan))
    assert any(td.split_dim(p) is not None for p in tree_leaves(plan))


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


def test_one_card_fastpath_on_equals_off(jax_runs):
    """The dense case with every fusable block fused: the W x M rows of a
    leaf in one call, the same params and state in f32 bits."""
    from repro_torch.tree import tree_items

    p0 = _section(jax_runs["dense-2x2"], "p0")
    off = _port_run("dense-2x2", p0)
    on = _port_run("dense-2x2", p0, fastpath="on")
    assert all(p.fused for _, p in tree_items(on[4]))
    for (path, a), (_, b) in zip(tree_items(on[1]), tree_items(off[1]),
                                 strict=True):
        assert np.array_equal(_bits(a), _bits(b)), path
    for (path, a), (_, b) in zip(tree_items(on[2]), tree_items(off[2]),
                                 strict=True):
        for x, y in zip(a, b, strict=True):
            assert np.array_equal(np.asarray(x).view(np.int32),
                                  np.asarray(y).view(np.int32)), path


# ---------------------------------------------------------------------------
# four gloo ranks
# ---------------------------------------------------------------------------
def _rank(rank, world, store, out_dir, p0s):
    """One of the 4 ranks: every case on ``make_host_groups(model=M)``,
    then 2 steps of ``CKPT_FLAGS`` with ``--checkpoint``; rank 0 saves
    the results, every rank its params' digest."""
    import torch.distributed as dist

    from repro_torch.core import distributed as td
    from repro_torch.launch import mesh, train
    from repro_torch.tree import tree_items, tree_leaves

    mesh.init_file_store(store, rank, world, "gloo")
    try:
        out = {}
        for name in CASES:
            M = CASES[name][1][1]
            groups = mesh.make_host_groups(model=M)
            assert (groups.rank, groups.shard) == (rank // M, rank % M)
            blocks = {}
            losses, params, state, ctrl, plan = _port_run(
                name, p0s[name], groups, blocks=blocks)
            out[name] = {"losses": losses, "params": params, "state": state,
                         "ctrl": ctrl, "digest": _digest(tree_leaves(params)),
                         "tensor_parallel": bool(blocks)}
            if blocks:  # each leaf's block shape, and the whole leaves' bits
                pl = tree_items(plan)
                local = tree_leaves(blocks["params"])
                out[name]["block_shapes"] = [
                    (tuple(x.shape), p.local_shape, p.global_shape)
                    for x, (_, p) in zip(local, pl, strict=True)]
                out[name]["whole_digest"] = _digest(
                    x for x, (_, p) in zip(local, pl, strict=True)
                    if td.split_dim(p) is None)
        train.run(train.parse_args([*CKPT_FLAGS, "--steps", "2",
                                    "--checkpoint", f"{out_dir}/ckpt"]),
                  mesh=mesh.make_host_groups(model=2))
        res = train.run(train.parse_args([*CKPT_FLAGS, "--steps", "3",
                                          *CALIBRATE_FLAGS]),
                        mesh=mesh.make_host_groups(model=2))
        calibrated = {"link": (res.dist.link_model.alpha,
                               res.dist.link_model.beta),
                      "wires": [(p.codec, p.collective, p.fused)
                                for p in tree_leaves(res.plan)],
                      "losses": res.losses}
        mine = ("digest", "tensor_parallel", "block_shapes", "whole_digest")
        torch.save({**(out if rank == 0 else {
                        n: {k: v for k, v in o.items() if k in mine}
                        for n, o in out.items()}),
                    "calibrated": calibrated},
                   f"{out_dir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _digest(leaves):
    return b"".join(x.contiguous().view(torch.int32).numpy().tobytes()
                    for x in leaves)


@pytest.fixture(scope="module")
def ranks_out(jax_runs, tmp_path_factory):
    from repro_torch.comm.controller import ControllerState
    from repro_torch.core.compact import CompactState
    from repro_torch.launch import mesh

    d = tmp_path_factory.mktemp("ranks_mp")
    p0s = {name: _section(run, "p0") for name, run in jax_runs.items()}
    mesh.spawn(_rank, 4, (str(d / "store"), str(d), p0s), timeout=120)
    with torch.serialization.safe_globals([CompactState, ControllerState]):
        return d, [torch.load(d / f"rank{r}.pt") for r in range(4)]


@pytest.mark.parametrize("name", list(CASES))
def test_four_ranks_match_jax(jax_runs, ranks_out, name):
    _, outs = ranks_out
    first = outs[0][name]
    assert all(o[name]["digest"] == first["digest"] for o in outs)
    # every case trains tensor parallel: the dense, MoE and SSM families
    from repro_torch import models

    cfg = _cfg("repro_torch", CASES[name][0])
    assert first["tensor_parallel"] == models.tensor_parallel(cfg), name
    assert first["tensor_parallel"], name
    if first["tensor_parallel"]:
        M = CASES[name][1][1]
        for o in outs:
            shapes = o[name]["block_shapes"]
            assert all(got == local for got, local, _ in shapes), name
            assert any(local != whole for _, local, whole in shapes), name
            assert sum(math.prod(got) for got, _, _ in shapes) < sum(
                math.prod(whole) for _, _, whole in shapes), (name, M)
            assert o[name]["whole_digest"] == first["whole_digest"], name
    _matches_jax((first["losses"], first["params"], first["state"],
                  first["ctrl"], None), jax_runs[name], name)


def test_four_rank_checkpoint_resumes_on_one_process(ranks_out):
    """The 4 ranks' ``--model-parallel 2`` checkpoint (rank 0 writes every
    (worker, shard)'s row, ``sent_* [2, 2, k]``) holds the one-card run's
    state, and ``--workers 4 --model-parallel 2 --resume`` continues it
    as the unbroken one-card run does."""
    from repro_torch import checkpoint as ckpt
    from repro_torch import convert
    from repro_torch.launch import train
    from repro_torch.tree import tree_items

    d, _ = ranks_out
    first = train.run(train.parse_args([*CKPT_FLAGS, "--steps", "2"]))
    want = convert.trainer_state_to_jax(first.sp_state, first.plan)
    got = ckpt.restore(f"{d}/ckpt/sparsifier", want)
    for (path, a), (_, b) in zip(tree_items(got), tree_items(want), strict=True):
        assert tuple(a.sent_idx.shape[:2]) == (2, 2), path
        assert torch.equal(a.t, b.t), path
        assert torch.equal(a.sent_idx.sort(-1).values, b.sent_idx.sort(-1).values)
        _close(a.eps.numpy(), b.eps.numpy(), path)
    whole = train.run(train.parse_args([*CKPT_FLAGS, "--steps", "4"]))
    rest = train.run(train.parse_args([*CKPT_FLAGS, "--steps", "2", "--resume",
                                       f"{d}/ckpt"]))
    np.testing.assert_allclose(whole.losses[2:], rest.losses, rtol=RTOL)
    for (path, a), (_, b) in zip(tree_items(rest.params),
                                 tree_items(whole.params), strict=True):
        _close(a.numpy(), b.numpy(), path)


def test_four_ranks_calibrate_and_replan_with_one_plan(ranks_out):
    """``--calibrate --replan-every 1`` under ``--codec auto --collective
    auto`` on the 4 ranks at ``(2, 2)``: the dp groups of both model
    indices probe at once, rank 0's fit reaches every rank, and every
    rank plans, replans and steps one plan."""
    from repro_torch.comm import cost

    _, outs = ranks_out
    first = outs[0]["calibrated"]
    assert first["link"] != (cost.AlphaBeta().alpha, cost.AlphaBeta().beta)
    assert all(o["calibrated"] == first for o in outs)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------
def test_cli_equals_run_at_the_same_layout(capsys):
    from repro_torch.launch import train

    flags = ["--smoke", "--workers", "4", "--model-parallel", "2", "--steps",
             "2", "--seq", "16", "--global-batch", "4", "--fastpath", "on",
             "--device", "cpu", "--log-every", "1"]
    assert train.main(flags) == 0
    out = capsys.readouterr().out
    assert out.splitlines()[0] == "mesh: {'data': 2, 'model': 2}, dp axes ('data',)"
    printed = [float(line.split()[3]) for line in out.splitlines()
               if line.startswith("step ")]
    res = train.run(train.parse_args(flags))
    assert printed == [float(f"{x:.4f}") for x in res.losses]
    assert all(p.shards == 2 for p in
               __import__("repro_torch.tree", fromlist=["tree_leaves"])
               .tree_leaves(res.plan))


@pytest.mark.parametrize("flags,match", [
    (["--workers", "4", "--model-parallel", "3"], "does not divide 4 devices"),
    (["--mesh", "production"], "needs 256 ranks"),
    (["--multi-pod"], "run under torchrun"),
])
def test_one_card_refuses_layouts_it_cannot_build(flags, match, monkeypatch):
    from repro_torch.launch import train
    from repro_torch.models import lm

    def boom(*a, **k):
        raise AssertionError("allocated before refusing")

    monkeypatch.setattr(lm, "init", boom)
    with pytest.raises(SystemExit, match=match):
        train.run(train.parse_args(["--smoke", "--device", "cpu", *flags]))


@pytest.mark.parametrize("flags,match", [
    (["--model-parallel", "3"], "does not divide 4 devices"),
    (["--mesh", "production"], "256 ranks.*512 with --multi-pod.*not 4"),
    (["--mesh", "production", "--multi-pod"], "not 4"),
    (["--multi-pod", "--model-parallel", "4"], "multiple of 8"),
])
def test_torchrun_refuses_before_the_process_group(flags, match, monkeypatch):
    import torch.distributed as dist

    from repro_torch.launch import train

    def boom(*a, **k):
        raise AssertionError("the process group started")

    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setattr(dist, "init_process_group", boom)
    with pytest.raises(SystemExit, match=match):
        train.main(["--smoke", "--device", "cpu", *flags])


if __name__ == "__main__":
    _jax_main(sys.argv[1])
