"""The JAX side of the dry-run tests (``tests/test_torch_dryrun*.py``),
run in a subprocess of 8 host devices:

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
        python tests/_torch_dryrun_jax.py OUT.json CASE...

A case is ``arch:shape:DxM[:field=value,...]``, or ``layout:arch:MESH``
(below). Each ``arch:shape:DxM`` case sets ``repro.launch.dryrun``'s
``CFG_OVERRIDES`` to the config's smoke-variant fields (:func:`overrides`)
and the case's own ``field=value`` pairs (:func:`case_overrides`),
lowers and compiles the combo with ``lower_train`` or ``lower_serve`` on a
``(data, model)`` mesh of Auto axes (``repro.compat.make_mesh`` gives
Explicit axes, which the trainer's ``with_sharding_constraint`` refuses
on jax 0.9), and writes ``repro.launch.hlo_cost.analyze``'s FLOPs and
collective bytes and ``argument_size_in_bytes`` to ``OUT.json``. Two more
walks name what the port does not count the same way: the FLOPs with
every ``convolution`` hidden from the walker (its ``2 x out x 8`` guess
for the depthwise conv), and the all-gathers with those of the MoE
router's ``top_k`` hidden (GSPMD gathers the router's scores across the
dp devices; the port has no partitioner).

A ``layout:arch:MESH`` case (``MESH`` ``16x16`` or ``2x16x16``) compiles
nothing: on an ``AbstractMesh`` of the production layout it writes the
published config's parameter specs (``tree_specs``), its moments' specs
(``zero1_specs``), its sparsifier state (``build_plan`` and
``sparsifier_state_shapes``) and the per-device bytes of ``lower_train``'s
arguments, each leaf's block under its spec (the tokens and labels
int32, as ``input_specs`` gives them).
"""
import dataclasses
import functools
import json
import re
import sys

# the published values kept: the precision of the state is the dry run's
# choice, and the published group size keeps a MoE step to 16 groups a
# worker where the smoke variant's 256 would make 256
KEEP = ("dtype", "moe_group_size")


def overrides(configs, arch):
    """``{field: str(value)}`` of the smoke variant's fields that differ
    from the published config, but ``KEEP``; ``configs`` is either
    package's ``configs`` module."""
    full = configs.get_config(arch)
    smoke = full.smoke_variant()
    return {f.name: str(getattr(smoke, f.name))
            for f in dataclasses.fields(smoke)
            if f.name not in KEEP
            and getattr(smoke, f.name) != getattr(full, f.name)}


def case_overrides(configs, case):
    """``(arch, shape, data, model, CFG_OVERRIDES)`` of an
    ``arch:shape:DxM[:field=value,...]`` case."""
    arch, shape, dims, *extra = case.split(":")
    data, model = (int(x) for x in dims.split("x"))
    cfg = overrides(configs, arch)
    for pair in extra:
        cfg.update(kv.split("=") for kv in pair.split(","))
    return arch, shape, data, model, cfg


def _hide(hlo, pattern, op):
    """``hlo`` with ``op`` renamed on the lines matching ``pattern``, so
    the walker skips it."""
    return "\n".join(line.replace(f" {op}(", f" hidden-{op}(")
                     if re.search(pattern, line) else line
                     for line in hlo.splitlines())


def run_case(case):
    import jax
    from jax.sharding import AxisType

    from repro import configs
    from repro.launch import dryrun, hlo_cost

    arch, shape, data, model, cfg = case_overrides(configs, case)
    dryrun.CFG_OVERRIDES.clear()
    dryrun.CFG_OVERRIDES.update(cfg)
    mesh = jax.make_mesh((data, model), ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto),
                         devices=jax.devices()[:data * model])
    kind = configs.INPUT_SHAPES[shape][2]
    lower = dryrun.lower_train if kind == "train" else dryrun.lower_serve
    compiled = lower(arch, shape, mesh)[0].compile()
    hlo = compiled.as_text()
    walk = hlo_cost.analyze(hlo)
    no_conv = hlo_cost.analyze(_hide(hlo, r" convolution\(", "convolution"))
    no_router = hlo_cost.analyze(_hide(hlo, r"top_k", "all-gather"))
    return {
        "flops": walk["flops"],
        "flops_without_conv": no_conv["flops"],
        "collective_bytes": walk["collective_bytes"],
        "all_gather_without_router": no_router["collective_bytes"].get(
            "all-gather", 0.0),
        "argument_bytes": compiled.memory_analysis().argument_size_in_bytes,
    }


def _items(tree, prefix=""):
    """``[(dotted path, leaf)]`` of a tree of dicts, sorted by key."""
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    out = []
    for key in sorted(tree):
        out += _items(tree[key], f"{prefix}.{key}" if prefix else key)
    return out


def _spec(spec, ndim):
    """A ``PartitionSpec`` as a list, one entry a dim."""
    entries = [list(e) if isinstance(e, tuple) else e for e in spec]
    return entries + [None] * (ndim - len(entries))


@functools.lru_cache(maxsize=None)
def _shapes(arch):
    """The published config in bf16 and its parameter shapes and axes."""
    from repro import configs
    from repro.core import distributed as jd
    from repro.models import get_family

    cfg = configs.get_config(arch).replace(dtype="bfloat16")
    return (cfg,) + tuple(jd.shapes_and_axes(get_family(cfg), cfg))


def layout_case(arch, mesh_name):
    import math

    import jax
    import numpy as np
    from jax.sharding import AbstractMesh

    from repro import configs
    from repro.core import distributed as jd
    from repro.launch import dryrun
    from repro.models import input_specs
    from repro.nn import sharding as shlib
    from repro.optim import make_optimizer

    sizes = tuple(int(x) for x in mesh_name.split("x"))
    names = ("data", "model") if len(sizes) == 2 else ("pod", "data", "model")
    mesh = AbstractMesh(sizes, names)
    cfg, params, axes = _shapes(arch)
    seq, global_batch, _ = configs.INPUT_SHAPES["train_4k"]
    dist = dryrun.arch_dist_config(arch, mesh)
    dp = tuple(dist.dp_axes)
    W = math.prod(mesh.shape[a] for a in dp)
    specs = shlib.tree_specs(params, axes, mesh, rules=dist.rules, dp_axes=dp)
    plan = jd.build_plan(params, specs, mesh, dist.sparsifier.sparsity, dist)
    state, state_specs = jd.sparsifier_state_shapes(
        plan, W, mesh, dp, jd._DT[dist.state_dtype])
    moments = dryrun.zero1_specs(params, specs, mesh, dp)
    opt = jax.eval_shape(lambda p: make_optimizer(dist.optimizer).init(p),
                         params)

    def nbytes(x, spec):
        local = jd._local_shape(x.shape, spec, mesh)
        return int(np.prod(local)) * np.dtype(x.dtype).itemsize

    state_items, spec_items = dict(_items(state)), dict(_items(state_specs))
    sparsifier, state_out = 0, {}
    for path, _ in _items(plan):
        st, sp = state_items[path], spec_items[path]
        state_out[path] = {}
        for field in st._fields:
            x, spec = getattr(st, field), getattr(sp, field)
            state_out[path][field] = [list(x.shape), str(x.dtype),
                                      _spec(spec, len(x.shape))]
            sparsifier += nbytes(x, spec)
    dp_spec = jax.sharding.PartitionSpec(dp if len(dp) > 1 else dp[0])
    p_items, s_items = _items(params), dict(_items(specs))
    m_items = dict(_items(moments))
    param_bytes = sum(nbytes(x, s_items[k]) for k, x in p_items)
    opt_bytes = 4 + sum(nbytes(x, m_items[k]) for key in opt if key != "step"
                        for k, x in _items(opt[key]))
    batch_bytes = sum(nbytes(x, dp_spec) for x in input_specs(
        cfg, global_batch, seq, kind="train").values())
    return {
        "param_specs": {k: _spec(s_items[k], len(x.shape)) for k, x in p_items},
        "mom_specs": {k: _spec(m_items[k], len(x.shape)) for k, x in p_items},
        "state": state_out,
        "argument_bytes": param_bytes + opt_bytes + sparsifier + batch_bytes,
    }


if __name__ == "__main__":
    out, cases = sys.argv[1], sys.argv[2:]
    with open(out, "w") as f:
        json.dump({case: layout_case(*case.split(":")[1:])
                   if case.startswith("layout:") else run_case(case)
                   for case in cases}, f)
