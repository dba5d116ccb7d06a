"""Tensor and expert parallelism for the MoE family (``nn.moe.moe_apply``
under a ``ModelShard`` and the trainer's tensor-parallel path for
``models.lm``'s ``moe`` family).

* The layer on 2 gloo CPU ranks against the same call whole in one
  process, forward and backward: both layouts (``"moe_mlp"``, each
  expert's FFN columns split; ``"experts_sharded"``, the experts split)
  under both dispatches (``"einsum"``, ``"gather"``), with shared experts
  (split on ``"mlp"``) and without, one case of each layout with three
  groups, the last padded, and dropped tokens, and two cases whose shard
  splits only the routed or only the shared experts. The output, the aux
  loss and every gradient to rtol 1e-5 (each split leaf's gradient the
  block of the whole one); the routing (``gate_idx``, ``keep``) equal
  exactly; the router's gradient equal in bits on both ranks; and the
  bytes the collectives returned, counted again by a ``ModelShard``
  without a group on meta tensors, equal to what ``nn.moe``'s docstring
  says a layer issues.
* The trainer: deepseek-moe-16b's smoke variant at ``(2, 2)`` and ``(1,
  4)`` in the tensor layout (at ``(1, 4)`` its 2 kv heads whole and a
  group size of 24, so a worker's 64 tokens make 3 groups, the last
  padded with 8 rows), at ``(2, 2)`` in the expert layout with the
  ``"gather"`` dispatch, and mixtral-8x7b's smoke variant at ``(1, 4)``
  in the expert layout (no shared experts, a sliding window, one expert a
  rank), 3 steps of RegTop-k at S = 0.01 and Adam on 4 gloo ranks
  against the jitted JAX trainer on the same mesh (one subprocess of 8
  host devices for the file, as ``tests/test_torch_tensor_parallel.py``):
  losses, parameters and ``eps`` to rtol 1e-5 with a floor of 1e-5 of a
  leaf's largest magnitude, ``sent_idx`` per (worker, shard) as sets,
  round counters exactly; each rank holds exactly its blocks of the split
  leaves, and every whole leaf (the router, the norms) is equal in bits
  on every rank.

Every wait is bounded at 120 s (the JAX subprocess at 300 s).
"""
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_model_parallel import (_batches, _close, _flatten, _nest,
                                       _section)

ROOT = Path(__file__).resolve().parents[1]
SPARSITY, LR, RTOL = 0.01, 1e-3, 1e-5
# name -> (config, (data, model), the smoke variant's fields replaced, the
# logical axes the model axis splits)
CASES = {
    "deepseek-tensor-2x2": (
        "deepseek-moe-16b", (2, 2), {},
        {"heads", "kv_heads", "mlp", "moe_mlp", "vocab"}),
    "deepseek-tensor-1x4": (
        "deepseek-moe-16b", (1, 4), {"moe_group_size": 24},
        {"heads", "mlp", "moe_mlp", "vocab"}),
    "deepseek-expert-gather-2x2": (
        "deepseek-moe-16b", (2, 2),
        {"moe_parallelism": "expert", "moe_dispatch": "gather"},
        {"heads", "kv_heads", "mlp", "experts_sharded", "vocab"}),
    "mixtral-expert-1x4": (
        "mixtral-8x7b", (1, 4), {"moe_parallelism": "expert"},
        {"heads", "experts_sharded", "vocab"}),
}


def _cfg(pkg, name):
    import importlib

    arch, _, fields, _ = CASES[name]
    cfg = importlib.import_module(f"{pkg}.configs").get_config(arch)
    return cfg.smoke_variant().replace(**fields)


# ---------------------------------------------------------------------------
# the JAX side, in a subprocess of 8 host devices
# ---------------------------------------------------------------------------
def _jax_case(name, out_dir):
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType

    from repro.core import distributed as jd
    from repro.core.sparsify import SparsifierConfig
    from repro.models import get_family
    from repro.optim import OptConfig, make_optimizer

    _, (W, M), _, _ = CASES[name]
    cfg = _cfg("repro", name)
    mesh = jax.make_mesh((W, M), ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto),
                         devices=jax.devices()[:W * M])
    dist = jd.DistConfig(
        sparsifier=SparsifierConfig(kind="regtopk", sparsity=SPARSITY),
        optimizer=OptConfig(kind="adam", learning_rate=LR),
        dp_axes=("data",))
    mod = get_family(cfg)
    asm = jd.assemble(mod, cfg, dist, mesh)
    params, _ = mod.init(jax.random.PRNGKey(0), cfg)
    p0 = _flatten(jax.tree.map(np.asarray, params))
    opt_state = make_optimizer(dist.optimizer).init(params)
    sp, _ = jd.init_sparsifier_state(asm.plan, W, mesh, ("data",), jnp.float32)
    step = jax.jit(asm.train_step)
    losses = []
    with mesh:
        for b in _batches(cfg.vocab, 7):
            params, opt_state, sp, m = step(params, opt_state, sp,
                                            jax.tree.map(jnp.asarray, b))
            losses.append(float(m["loss"]))
    np.savez(f"{out_dir}/{name}.npz", losses=np.array(losses),
             **{f"p0/{k}": v for k, v in p0.items()},
             **{f"params/{k}": v for k, v in
                _flatten(jax.tree.map(np.asarray, params)).items()},
             **{f"state/{k}": v for k, v in
                _flatten(jax.tree.map(np.asarray, sp)).items()})


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_tp_moe")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    res = subprocess.run([sys.executable, __file__, str(out)], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    return {name: dict(np.load(out / f"{name}.npz")) for name in CASES}


# ---------------------------------------------------------------------------
# the port on a rank
# ---------------------------------------------------------------------------
def _port_case(name, p0, groups):
    """Three steps of case ``name`` on this rank of ``groups``, tensor
    parallel from its blocks of ``p0``: the losses, the params gathered
    whole, the state of every (worker, shard) in the JAX layout, the axes
    the shard splits, each leaf's (held, block, whole) shapes and the bits
    of the whole leaves."""
    from repro_torch import convert
    from repro_torch.core import distributed as td
    from repro_torch.core.sparsify import SparsifierConfig
    from repro_torch.launch import train
    from repro_torch.models import param_axes
    from repro_torch.nn.sharding import shard_params, unshard_params
    from repro_torch.optim import OptConfig, make_optimizer
    from repro_torch.tree import tree_items, tree_map

    _, (W, M), _, _ = CASES[name]
    cfg = _cfg("repro_torch", name)
    dist = td.DistConfig(
        sparsifier=SparsifierConfig(kind="regtopk", sparsity=SPARSITY),
        optimizer=OptConfig(kind="adam", learning_rate=LR))
    whole = convert.params_from_jax(_nest(p0), device="cpu")
    plan = td.build_plan(whole, SPARSITY, dist, axes=param_axes(cfg),
                         mesh={"data": W, "model": M})
    specs = tree_map(lambda p: p.spec, plan)
    shard = td.model_shard(cfg, plan, groups.model_group, groups.shard)
    params = shard_params(whole, specs, groups.shard, M)
    step = td.make_train_step(cfg, dist, plan, W, mesh=groups)
    opt_state = make_optimizer(dist.optimizer).init(params)
    sp = td.init_sparsifier_state(plan, 1, "cpu", shards=1)
    losses = []
    for b in _batches(cfg.vocab, 7):
        batch = {k: torch.from_numpy(v).long() for k, v in b.items()}
        params, opt_state, sp, m = step(params, opt_state, sp, batch)
        losses.append(float(m["loss"]))
    items = [(path, x, p) for (path, x), (_, p) in zip(
        tree_items(params), tree_items(plan), strict=True)]
    return {
        "losses": losses,
        "split": set(shard.split),
        "params": unshard_params(params, specs, groups.model_group, M),
        "state": convert.trainer_state_to_jax(train._all_workers(sp, groups),
                                              plan),
        "shapes": {path: (tuple(x.shape), p.local_shape, p.global_shape)
                   for path, x, p in items},
        "whole": {path: x.contiguous().view(torch.int32).numpy().tobytes()
                  for path, x, p in items if td.split_dim(p) is None},
    }


def _rank(rank, world, store, out_dir, p0s):
    """One of the 4 ranks: every case; each rank saves its results."""
    import torch.distributed as dist

    from repro_torch.launch import mesh

    mesh.init_file_store(store, rank, world, "gloo")
    try:
        out = {name: _port_case(name, p0s[name],
                                mesh.make_host_groups(model=CASES[name][1][1]))
               for name in CASES}
        torch.save(out, f"{out_dir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks_out(jax_runs, tmp_path_factory):
    from repro_torch.core.compact import CompactState
    from repro_torch.launch import mesh

    d = tmp_path_factory.mktemp("ranks_tp_moe")
    p0s = {name: _section(run, "p0") for name, run in jax_runs.items()}
    mesh.spawn(_rank, 4, (str(d / "store"), str(d), p0s), timeout=120)
    with torch.serialization.safe_globals([CompactState]):
        return [torch.load(d / f"rank{r}.pt") for r in range(4)]


@pytest.mark.parametrize("name", list(CASES))
def test_four_ranks_match_jax(jax_runs, ranks_out, name):
    from repro_torch.tree import tree_items

    _, (W, M), _, split = CASES[name]
    run, want = ranks_out[0][name], jax_runs[name]
    assert run["split"] == split, name
    np.testing.assert_allclose(run["losses"], want["losses"], rtol=RTOL,
                               err_msg=name)
    jparams = _section(want, "params")
    for path, leaf in tree_items(run["params"]):
        _close(leaf.numpy(), jparams[path], f"{name} {path}")
    jstate = _section(want, "state")
    for path, st in tree_items(run["state"]):
        where = f"{name} {path}"
        np.testing.assert_array_equal(st.t.numpy(), jstate[f"{path}:t"],
                                      err_msg=where)
        _close(st.eps.numpy(), jstate[f"{path}:eps"], where)
        idx, jidx = st.sent_idx.numpy(), jstate[f"{path}:sent_idx"]
        for w in range(W):
            for m in range(M):
                assert sorted(idx[w, m]) == sorted(jidx[w, m]), (where, w, m)
    for o in ranks_out:  # each rank: its blocks, and the whole leaves in bits
        shapes = o[name]["shapes"]
        assert all(held == tuple(block) for held, block, _ in shapes.values())
        assert sum(math.prod(h) for h, _, _ in shapes.values()) < sum(
            math.prod(g) for _, _, g in shapes.values())
        assert o[name]["whole"] == run["whole"], name
    blocks = {path for path, (_, block, whole) in run["shapes"].items()
              if tuple(block) != tuple(whole)}
    assert {"layers.mlp.wg", "layers.mlp.wu", "layers.mlp.wd"} <= blocks
    assert {"layers.mlp.router", "layers.norm1.scale", "layers.norm2.scale",
            "final_norm.scale"} <= set(run["whole"]), name
    # the expert dim (1 of [L, E, D, F]) in the expert layout, the width
    # (3 of wg, 2 of wd) in the tensor layout
    E_dim = "experts_sharded" in split
    wg_held, _, wg_whole = run["shapes"]["layers.mlp.wg"]
    assert (wg_held[1] == wg_whole[1] // M) == E_dim, wg_held
    assert (wg_held[3] == wg_whole[3] // M) != E_dim, wg_held


# ---------------------------------------------------------------------------
# the layer on 2 ranks, against one process
# ---------------------------------------------------------------------------
D, E, FF, SF, K = 16, 4, 8, 12, 2
# name -> (layout, dispatch, shared experts, group size, the branches the
# shard splits: "both", or only the "routed" or the "shared" experts, as
# the model axis splits one leaf and not another that it does not
# divide); 10 tokens
LAYER_CASES = {
    **{f"{lay}-{disp}-{'shared' if sh else 'routed'}": (lay, disp, sh, 16,
                                                         "both")
       for lay in ("tensor", "expert") for disp in ("einsum", "gather")
       for sh in (True, False)},
    # 3 groups of 4 tokens, the last padded with 2 rows; 2 slots an
    # expert, so some choices drop
    "tensor-einsum-shared-padded": ("tensor", "einsum", True, 4, "both"),
    "expert-gather-shared-padded": ("expert", "gather", True, 4, "both"),
    # the routed partial sum leaves alone and the whole shared output is
    # added after it; the shared partial sum leaves alone and the routing
    # is whole
    "tensor-gather-only-routed-split": ("tensor", "gather", True, 16,
                                        "routed"),
    "expert-einsum-only-shared-split": ("expert", "einsum", True, 16,
                                        "shared"),
}
AUX_COEF = 0.1


def _layer_inputs():
    g = torch.Generator().manual_seed(5)
    return {"x": torch.randn(2, 5, D, generator=g),
            "router": torch.randn(D, E, generator=g),
            "wg": torch.randn(E, D, FF, generator=g) / 4,
            "wu": torch.randn(E, D, FF, generator=g) / 4,
            "wd": torch.randn(E, FF, D, generator=g) / 3,
            "swg": torch.randn(D, SF, generator=g) / 4,
            "swu": torch.randn(D, SF, generator=g) / 4,
            "swd": torch.randn(SF, D, generator=g) / 3}


def _split_dims(layout, split):
    """Each leaf's split dim over the model group (None: whole)."""
    e = {"wg": 0, "wu": 0, "wd": 0} if layout == "expert" else (
        {"wg": 2, "wu": 2, "wd": 1})
    s = {"swg": 1, "swu": 1, "swd": 0}
    if split == "shared":
        e = dict.fromkeys(e)
    if split == "routed":
        s = dict.fromkeys(s)
    return {"router": None, **e, **s}


def _split_axes(layout, split):
    """The logical axes a case's ``ModelShard`` splits."""
    routed = "moe_mlp" if layout == "tensor" else "experts_sharded"
    return {"both": {"mlp", routed}, "routed": {routed},
            "shared": {"mlp"}}[split]


def _layer_results(group=None, rank=None, device="cpu"):
    """Each layer case's output, aux, routing, the gradients of its input
    and leaves under a fixed cotangent (plus ``AUX_COEF`` times the aux),
    and the bytes its collectives returned: whole (``rank`` None), or
    rank ``rank``'s blocks of 2 over ``group`` (None: on the meta device,
    counted only)."""
    from repro_torch.nn import moe as M
    from repro_torch.nn import tensor_parallel as TP

    t = {k: v.to(device) for k, v in _layer_inputs().items()}
    out = {}
    route = M.route
    for name, (layout, dispatch, shared, gs, split) in LAYER_CASES.items():
        shard = (None if rank is None else TP.ModelShard(
            group, rank, 2, frozenset(_split_axes(layout, split))))
        w = {"x": t["x"].clone().requires_grad_(True)}
        for leaf, d in _split_dims(layout, split).items():
            if leaf.startswith("s") and not shared:
                continue
            x = t[leaf]
            if shard is not None and d is not None:
                x = x.narrow(d, rank * (x.shape[d] // 2), x.shape[d] // 2)
            w[leaf] = x.clone().requires_grad_(True)
        p = {k: w[k] for k in ("router", "wg", "wu", "wd")}
        if shared:
            p["shared"] = {"wg": w["swg"], "wu": w["swu"], "wd": w["swd"]}
        routes = []

        def recorded(*a, **kw):
            r = route(*a, **kw)
            routes.append((r[1].detach(), r[3].detach()))
            return r

        M.route = recorded
        try:
            y, aux = M.moe_apply(p, w["x"], top_k=K, group_size=gs,
                                 dispatch=dispatch, shard=shard)
        finally:
            M.route = route
        cot = torch.linspace(-1, 1, y.numel()).reshape(y.shape).to(device)
        grads = torch.autograd.grad((y * cot).sum() + AUX_COEF * aux,
                                    list(w.values()))
        out[name] = {"y": y.detach(), "aux": aux.detach(), "routes": routes,
                     "grads": {k: g.detach() for k, g in zip(w, grads,
                                                             strict=True)},
                     "traffic": None if shard is None else dict(shard.traffic)}
    return out


def _layer_rank(rank, world, store, out_dir):
    import torch.distributed as dist

    from repro_torch.launch import mesh

    mesh.init_file_store(store, rank, world, "gloo")
    try:
        torch.save(_layer_results(dist.group.WORLD, rank),
                   f"{out_dir}/layer{rank}.pt")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def layer_out(tmp_path_factory):
    from repro_torch.launch import mesh

    d = tmp_path_factory.mktemp("tp_moe_layer")
    mesh.spawn(_layer_rank, 2, (str(d / "store"), str(d)), timeout=120)
    return [torch.load(d / f"layer{r}.pt") for r in range(2)]


@pytest.mark.parametrize("name", list(LAYER_CASES))
def test_layer_on_two_ranks_equals_one_process(layer_out, name):
    """Forward and backward of ``moe_apply`` on 2 gloo ranks: the output,
    the aux and the input's gradient whole on both ranks, each leaf's
    gradient the block of the whole one, the routing exactly the one
    process's and the router's gradient equal in bits on both ranks."""
    layout, split = LAYER_CASES[name][0], LAYER_CASES[name][4]
    want = _layer_results()[name]
    dims = _split_dims(layout, split)
    for rank, out in enumerate(layer_out):
        got = out[name]
        tol = dict(rtol=RTOL, atol=1e-6)
        torch.testing.assert_close(got["y"], want["y"], **tol)
        torch.testing.assert_close(got["aux"], want["aux"], **tol)
        assert len(got["routes"]) == len(want["routes"]) > 0
        for (gi, keep), (wgi, wkeep) in zip(got["routes"], want["routes"],
                                            strict=True):
            assert torch.equal(gi, wgi) and torch.equal(keep, wkeep), name
        for leaf, g in want["grads"].items():
            d = dims.get(leaf)
            if d is not None:
                g = g.narrow(d, rank * (g.shape[d] // 2), g.shape[d] // 2)
            torch.testing.assert_close(got["grads"][leaf], g, **tol,
                                       msg=f"{name} {leaf} rank {rank}")
    r0, r1 = (o[name]["grads"]["router"] for o in layer_out)
    assert torch.equal(r0.view(torch.int32), r1.view(torch.int32)), name
    # some choices drop where an expert has 2 slots
    if LAYER_CASES[name][3] == 4:
        assert not all(bool(keep.all()) for _, keep in want["routes"])


def test_layer_collectives_are_the_docstrings(layer_out):
    """Each case's bytes, as the ranks' collectives returned them and as a
    ``ModelShard`` without a group counts them on meta tensors: one
    all-reduce of ``x`` forward (the routed and shared partial sums
    together, or the one that is split), one of ``x``'s gradient and, with
    the routed experts split, one of each group's ``[g, top_k]`` float32
    gates' gradient backward; no gather."""
    meta = _layer_results(None, 0, "meta")
    T = 10
    for name, (_, _, _, gs, split) in LAYER_CASES.items():
        g = min(gs, T)
        n_groups = -(-T // g)
        gates = 0 if split == "shared" else n_groups * g * K * 4
        want = {"all-reduce": 2 * T * D * 4 + gates, "all-gather": 0}
        assert meta[name]["traffic"] == want, name
        for out in layer_out:
            assert out[name]["traffic"] == want, name


def test_the_layer_alone_moves_nothing_whole():
    """Without a shard, and under a shard that splits none of the layer's
    axes, ``moe_apply`` issues no collective and is the one-process layer
    in bits."""
    from repro_torch.nn import moe as M
    from repro_torch.nn import tensor_parallel as TP

    t = _layer_inputs()
    p = {k: t[k] for k in ("router", "wg", "wu", "wd")}
    p["shared"] = {"wg": t["swg"], "wu": t["swu"], "wd": t["swd"]}
    shard = TP.ModelShard(None, 0, 2, frozenset({"heads", "vocab"}))
    y0, a0 = M.moe_apply(p, t["x"], top_k=K, group_size=4)
    y1, a1 = M.moe_apply(p, t["x"], top_k=K, group_size=4, shard=shard)
    assert torch.equal(y0, y1) and torch.equal(a0, a1)
    assert shard.traffic == {"all-reduce": 0, "all-gather": 0}


if __name__ == "__main__":
    for case in CASES:
        _jax_case(case, sys.argv[1])
