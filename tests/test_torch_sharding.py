"""The port's sharding rules, logical axes and per-shard plans
(``repro_torch.nn.sharding``, each family's ``param_axes``,
``core.distributed.build_plan(axes=, mesh=)``) against the JAX package's
``repro.nn.sharding``, ``shapes_and_axes`` and ``build_plan``.

* ``resolve_spec`` / ``tree_specs`` equal the JAX package's on the
  divisibility guard (a dim smaller than the axis, a dim the axis does not
  divide), one and two dp axes, ``"__dp__"`` and a ``rules`` override.
* ``param_axes(cfg)`` equals ``shapes_and_axes(mod, cfg)[1]`` for all
  twelve configs and their smoke variants, and for deepseek-moe-16b's
  smoke variant under ``moe_parallelism="expert"``.
* On the meshes ``(2, 2)``, ``(1, 4)``, ``(4, 2)``, ``(16, 16)`` and
  ``(2, 16, 16)`` (``AbstractMesh``es: no devices), the port's plan of
  every config equals JAX's ``build_plan`` field by field (global and
  local shape, local length, k, spec and the fused flag under fastpath
  "on"), and under ``codec``/``collective="auto"`` the per-leaf picks, both
  packages pricing with one ``ThroughputTable``. The one difference is
  the port's: a block of ``MAX_WIRE_LEN`` (2**31) elements or more (the
  tensor-parallel experts of mixtral-8x7b and deepseek-moe-16b on a small
  model axis) is refused on the COO codecs' int32 wire, where JAX's plan
  fuses it; its shapes are held from the plan without a wire.
* The layout arithmetic of ``launch.mesh`` for the host and production
  layouts, with no process group.
"""
import functools

import jax
import numpy as np
import pytest
from jax.sharding import AbstractMesh

from repro import configs as jconfigs
from repro.comm import fastpath as jfp
from repro.core import distributed as jd
from repro.core.sparsify import SparsifierConfig as JaxSparsifierConfig
from repro.models import get_family as jax_family
from repro.nn import sharding as jsh
from repro_torch import configs as tconfigs
from repro_torch.comm import codec as tcodec
from repro_torch.comm import fastpath as tfp
from repro_torch.core import distributed as td
from repro_torch.core.sparsify import SparsifierConfig
from repro_torch.launch import mesh as tmesh
from repro_torch.models import get_family, param_axes
from repro_torch.nn import sharding as tsh
from repro_torch.tree import tree_items

ARCHS = tuple(jconfigs.ARCHS)
MESHES = {
    "2x2": ((2, 2), ("data", "model")),
    "1x4": ((1, 4), ("data", "model")),
    "4x2": ((4, 2), ("data", "model")),
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
}
SPARSITY = 0.001
JAX_RATE = jfp.ThroughputTable().fused_bps


def _jspec(spec):
    return tuple(spec)


def _is_axes(x):
    return isinstance(x, tuple) and all(isinstance(a, (str, type(None))) for a in x)


def _plain(tree):
    """A JAX axes tree with every logical-axes sequence as a tuple."""
    return jax.tree.map(tuple, tree, is_leaf=_is_axes)


@pytest.mark.parametrize("axes,shape", [
    (("embed", "mlp"), (64, 128)),
    (("vocab", "embed"), (6, 64)),          # 6 % 4 != 0: whole
    (("layers", "kv_heads", "head_dim"), (3, 2, 16)),  # 2 < 4: whole
    (("heads", "head_dim"), (4, 16)),
    (("batch", "seq", "embed"), (8, 16, 64)),
    (("worker", "mlp"), (3, 128)),          # 3 not divisible by the dp size
    (("experts", "embed", "moe_mlp"), (8, 64, 64)),
    ((None, "d_inner"), (4, 64)),
])
@pytest.mark.parametrize("mesh", [
    {"data": 2, "model": 4},
    {"data": 1, "model": 4},
    {"data": 4, "model": 1},
    {"pod": 2, "data": 2, "model": 2},
])
@pytest.mark.parametrize("rules", [None, {"experts": "model"},
                                   {"embed": "model", "mlp": None}])
def test_resolve_spec_matches_jax(axes, shape, mesh, rules):
    dp = tmesh.dp_axes_of(mesh)
    amesh = AbstractMesh(tuple(mesh.values()), tuple(mesh))
    want = _jspec(jsh.resolve_spec(axes, shape, amesh, rules, dp))
    got = tsh.resolve_spec(axes, shape, mesh, rules, dp)
    assert got == want + (None,) * (len(got) - len(want))


def test_default_rules_are_the_jax_rules():
    assert tsh.DEFAULT_RULES == jsh.DEFAULT_RULES


def _cfgs():
    """``(id, jax config, port config)`` for every arch, published and
    smoke, and deepseek-moe-16b's smoke variant under expert parallelism."""
    out = []
    for name in ARCHS:
        jc, tc = jconfigs.get_config(name), tconfigs.get_config(name)
        out.append((name, jc, tc))
        out.append((f"{name}-smoke", jc.smoke_variant(), tc.smoke_variant()))
    jc = jconfigs.get_config("deepseek-moe-16b").smoke_variant()
    tc = tconfigs.get_config("deepseek-moe-16b").smoke_variant()
    out.append(("deepseek-moe-16b-smoke-expert",
                jc.replace(moe_parallelism="expert"),
                tc.replace(moe_parallelism="expert")))
    return out


CFGS = {name: (jc, tc) for name, jc, tc in _cfgs()}


@functools.lru_cache(maxsize=None)
def _jax_shapes(name):
    jc, _ = CFGS[name]
    return jd.shapes_and_axes(jax_family(jc), jc)


@functools.lru_cache(maxsize=None)
def _port_meta(name):
    _, tc = CFGS[name]
    return get_family(tc).init(tc, device="meta")


@pytest.mark.parametrize("name", list(CFGS))
def test_param_axes_match_jax(name):
    _, tc = CFGS[name]
    want = _plain(_jax_shapes(name)[1])
    assert param_axes(tc) == want
    # the axes cover the parameter tree leaf for leaf, one name a dim
    shapes = dict(tree_items(_port_meta(name)))
    for path, ax in tree_items(param_axes(tc)):
        assert len(ax) == len(shapes[path].shape), path


def test_expert_parallel_shards_the_experts_not_their_width():
    _, tc = CFGS["deepseek-moe-16b-smoke-expert"]
    axes = param_axes(tc)["layers"]["mlp"]
    assert axes["wg"] == ("layers", "experts_sharded", "embed", None)
    assert axes["wd"] == ("layers", "experts_sharded", None, "embed")
    specs = tsh.tree_specs(_port_meta("deepseek-moe-16b-smoke-expert"),
                           param_axes(tc), {"data": 2, "model": 2})
    assert specs["layers"]["mlp"]["wg"] == (None, "model", None, None)


def _dists(auto):
    kw = dict(sparsifier=SparsifierConfig(kind="regtopk", sparsity=SPARSITY),
              fastpath="on")
    jkw = dict(sparsifier=JaxSparsifierConfig(kind="regtopk",
                                              sparsity=SPARSITY),
               fastpath="on")
    if auto:
        kw.update(codec="auto", collective="auto")
        jkw.update(codec="auto", collective="auto")
    return kw, jkw


@pytest.mark.parametrize("auto", [False, True], ids=["fixed", "auto"])
@pytest.mark.parametrize("mesh_id", list(MESHES))
def test_plans_match_jax_build_plan(mesh_id, auto):
    """Every config's plan on the mesh, field by field; under "auto" the
    per-leaf (codec, collective, fused) picks too."""
    sizes, names = MESHES[mesh_id]
    amesh = AbstractMesh(sizes, names)
    mesh = dict(zip(names, sizes))
    dp = tmesh.dp_axes_of(mesh)
    kw, jkw = _dists(auto)
    tdist = td.DistConfig(dp_axes=dp, **kw)
    jdist = jd.DistConfig(dp_axes=dp, **jkw)
    beyond = set()
    for name in ARCHS:
        jshape, jaxes = _jax_shapes(name)
        jspecs = jsh.tree_specs(jshape, jaxes, amesh, None, dp)
        jplan = dict(tree_items(
            jd.build_plan(jshape, jspecs, amesh, SPARSITY, jdist)))
        params, axes = _port_meta(name), param_axes(CFGS[name][1])
        # the port's int32 wire guard: a block of MAX_WIRE_LEN elements or
        # more on a COO codec is refused; its shape fields are held from
        # the plan without a wire, the other leaves' wire under tdist
        shapes = dict(tree_items(td.build_plan(params, SPARSITY, axes=axes,
                                               mesh=mesh)))
        long = {path for path, p in shapes.items()
                if p.local_len >= tcodec.MAX_WIRE_LEN}
        table = tfp.ThroughputTable(JAX_RATE, JAX_RATE)
        try:
            plan = dict(tree_items(td.build_plan(
                params, SPARSITY, tdist, table, axes=axes, mesh=mesh)))
        except ValueError as e:
            assert long and "MAX_WIRE_LEN" in str(e), (name, e)
            plan = dict(tree_items(td.build_plan(
                _without(params, long), SPARSITY, tdist, table,
                axes=_without(axes, long), mesh=mesh)))
        else:  # "auto" may send them on a wire without indices
            for path in long:
                cname, coll = td.leaf_wire(plan.pop(path), tdist)
                assert auto and (coll == "dense_allreduce" or not
                                 tcodec.get_codec(cname).int32_indices), path
        assert plan.keys() | long == jplan.keys(), name
        for path, p in {**plan, **{q: shapes[q] for q in long}}.items():
            jp, where = jplan[path], f"{name} {mesh_id} {path}"
            assert p.global_shape == tuple(jp.global_shape), where
            assert p.local_shape == tuple(jp.local_shape), where
            assert p.local_len == jp.local_len and p.k == jp.k, where
            assert p.spec == _jspec(jp.spec), where
            assert p.shards == mesh["model"], where
            if p.local_len >= tfp.MAX_FUSED_LEN:  # kernel 1's int32 guard
                beyond.add(f"{name}:{path}")
                assert path in long and jp.fused, where
                continue
            assert p.fused == jp.fused, where
            if auto:
                assert (p.codec, p.collective) == (jp.codec, jp.collective), where
    # the tensor-parallel experts: mixtral-8x7b's up to M = 4 (3.76e9
    # elements a block there), deepseek-moe-16b's at M = 2 (2.58e9);
    # phi3-medium-14b's 3.67e9-element MLP leaves fit once split
    big = {2: ("mixtral-8x7b", "deepseek-moe-16b"), 4: ("mixtral-8x7b",),
           16: ()}[mesh["model"]]
    experts = {f"{name}:layers.mlp.{w}" for w in ("wd", "wg", "wu")
               for name in big}
    assert beyond == experts


def _without(tree, paths):
    """``tree`` (nested dicts) without the leaves at the dotted ``paths``."""
    out = {}
    for key, sub in tree.items():
        inner = {p.split(".", 1)[1] for p in paths if p.split(".", 1)[0] == key
                 and "." in p}
        if key in paths:
            continue
        out[key] = _without(sub, inner) if inner else sub
    return out


def test_plan_without_a_mesh_is_whole():
    params = _port_meta("qwen2.5-3b-smoke")
    plan = td.build_plan(params, SPARSITY)
    for _, p in tree_items(plan):
        assert p.local_shape == p.global_shape and p.shards == 1
        assert p.spec == (None,) * len(p.global_shape)
    with pytest.raises(ValueError, match="axes="):
        td.build_plan(params, SPARSITY, mesh={"data": 1, "model": 2})


def test_qwen_kv_heads_stay_whole_at_four_shards():
    """qwen2.5-3b's 2 KV heads divide a model axis of 2, not of 4: at
    ``(1, 4)`` ``wk``, ``wv`` and their biases stay whole beside the
    sharded ``wq``, 7 of 14 leaves in all."""
    name = "qwen2.5-3b"
    for mesh, whole in (({"data": 2, "model": 2}, 3),
                        ({"data": 1, "model": 4}, 7)):
        plan = dict(tree_items(td.build_plan(
            _port_meta(name), SPARSITY, axes=param_axes(CFGS[name][1]),
            mesh=mesh)))
        left = sorted(path for path, p in plan.items()
                      if td.split_dim(p) is None)
        assert len(plan) == 14 and len(left) == whole, left
        if mesh["model"] == 4:
            assert {"layers.attn.wk", "layers.attn.bk"} <= set(left)
            assert td.split_dim(plan["layers.attn.wq"]) == 2


def test_host_and_production_layouts():
    assert tmesh.host_shape(8, 2) == {"data": 4, "model": 2}
    assert tmesh.host_shape(8, 2, multi_pod=True) == {"pod": 2, "data": 2,
                                                      "model": 2}
    with pytest.raises(ValueError, match="does not divide"):
        tmesh.host_shape(6, 4)
    with pytest.raises(ValueError, match="multiple of 8"):
        tmesh.host_shape(4, 4, multi_pod=True)
    for multi_pod, world in ((False, 256), (True, 512)):
        shape = tmesh.production_shape(multi_pod)
        tmesh.check_world(shape, world, production=True)
        with pytest.raises(ValueError, match="256 ranks.*512 with --multi-pod"):
            tmesh.check_world(shape, 4, production=True)
        assert tmesh.model_size(shape) == 16
        assert tmesh.dp_axes_of(shape) == (("pod", "data") if multi_pod
                                           else ("data",))


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_rank_layout(multi_pod):
    """Ranks row-major with the model axis fastest, as the JAX device mesh
    (``np.arange(world).reshape(shape)``): rank r is worker r // 16 and
    shard r % 16; every group holds the ranks the mesh puts on its line,
    and the groups partition the world once per axis."""
    shape = tmesh.production_shape(multi_pod)
    grid = np.arange(int(np.prod(list(shape.values())))).reshape(
        tuple(shape.values()))
    names = list(shape)
    for r in (0, 1, 17, 255, 300, 511):
        if r >= grid.size:
            continue
        c = tmesh.rank_coords(r, shape)
        assert grid[tuple(c[a] for a in names)] == r
        assert r // 16 == (c.get("pod", 0) * 16 + c["data"])
        assert r % 16 == c["model"]
    groups = tmesh.layout_groups(shape)
    for axis in names:
        lines = [ranks for ax, ranks in groups if ax == axis]
        assert sorted(sum(lines, [])) == list(range(grid.size)), axis
        ax = names.index(axis)
        want = np.moveaxis(grid, ax, -1).reshape(-1, shape[axis])
        assert sorted(map(tuple, lines)) == sorted(map(tuple, want.tolist()))
    # the dp groups of each model index first, then the model groups
    kinds = [ax for ax, _ in groups]
    assert kinds.index("model") == len(groups) - grid.size // 16
    first = [ranks for ax, ranks in groups[:len(groups) - grid.size // 16]]
    assert all(r % 16 == 0 for ranks in first[:len(first) // 16] for r in ranks)
