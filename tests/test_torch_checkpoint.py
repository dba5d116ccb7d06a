"""The port's checkpoint store (``repro_torch.checkpoint``) and the
trainer's ``--checkpoint``/``--resume``, against the JAX package's
``repro.checkpoint`` and trainer.

* The store round-trips f32, bf16, int32 and int64 trees (dicts, tuples,
  lists, NamedTuples, ``None``) in bits, and its ``treedef`` string is
  ``str(jax.tree.structure(...))`` of the same tree, so ``meta.msgpack``
  is byte for byte the JAX store's.
* The port's msgpack codec writes what ``msgpack.packb`` writes and reads
  what ``msgpack.unpackb`` reads, for every type the metadata map uses.
* A checkpoint written by the JAX trainer's step at W = 1 (paper-resnet-
  proxy's smoke variant, ``repro.checkpoint.save`` as the JAX trainer
  calls it) resumes in the port's trainer (``--resume``), and the port's
  ``--checkpoint`` restores in the JAX package, every leaf in bits; each
  continuation matches the other stack's to ``tests/test_torch_train.py``'s
  tolerances (rtol 1e-5 with a floor of 1e-5 of a leaf's largest
  magnitude), sent indices and round counters exactly.
* A resumed port run against the unbroken one, at W = 1 and at W = 4 under
  ``round_robin:2`` and ``--adaptive-k``: the restored files equal the
  state they were written from in bits; the run that follows agrees to the
  same tolerances (the model's CPU backward is not deterministic), with
  indices, counters and the controller's k exact.
* A checkpoint written by 2 gloo ranks resumes in one process with
  ``--workers 2``. The ranks are spawned once, start their process group
  from a file under ``tmp_path`` and are waited for at most 120 s; this
  file imports ``jax`` only inside the tests, so a spawned rank loads no
  JAX.
"""
from typing import NamedTuple

import numpy as np
import pytest
import torch

from repro_torch import checkpoint as ckpt
from repro_torch import convert
from repro_torch.checkpoint import store
from repro_torch.tree import tree_items

RTOL = 1e-5
BASE = ["--smoke", "--seq", "16", "--global-batch", "4", "--device", "cpu",
        "--log-every", "100"]


class Pair(NamedTuple):
    a: object
    b: object


def _tree(rng, wide=np.int64):
    """A tree of every leaf kind; JAX (no x64) holds ``wide=np.int32``."""
    return {
        "w": torch.from_numpy(rng.standard_normal((3, 5)).astype(np.float32)),
        "opt": {"step": torch.tensor(7, dtype=torch.int32),
                "m": [torch.from_numpy(rng.standard_normal(4).astype(np.float32))
                      .to(torch.bfloat16), None]},
        "idx": (torch.from_numpy(rng.integers(0, 1 << 30, 6).astype(wide)
                                 << (10 if wide == np.int64 else 0)),
                torch.from_numpy(rng.integers(-9, 9, (2, 2)).astype(np.int32))),
        "pair": Pair(torch.tensor(-0.0), torch.zeros(0)),
    }


def _jnp_tree(tree):
    import jax.numpy as jnp

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*(conv(c) for c in x))
        if isinstance(x, (tuple, list)):
            return type(x)(conv(c) for c in x)
        if x is None:
            return None
        if x.dtype == torch.bfloat16:
            return jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
        return jnp.asarray(x.numpy())

    return conv(tree)


def _leaf_bits(x):
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        x = x.numpy()
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        return x.view(np.int16)
    return x.view(np.int32) if x.dtype == np.float32 else x


def _assert_bits(a, b, msg=""):
    fa, _ = store.tree_flatten(a)
    fb, _ = store.tree_flatten(b)
    assert len(fa) == len(fb), msg
    for i, (x, y) in enumerate(zip(fa, fb, strict=True)):
        bx, by = _leaf_bits(x), _leaf_bits(y)
        assert bx.dtype == by.dtype and bx.shape == by.shape, (msg, i)
        np.testing.assert_array_equal(bx, by, err_msg=f"{msg} leaf {i}")


def test_store_round_trips_dtypes_in_bits(tmp_path):
    tree = _tree(np.random.default_rng(0))
    ckpt.save(str(tmp_path / "c"), tree, metadata={"step": 12, "note": "x"})
    got = ckpt.restore(str(tmp_path / "c"), tree)
    _assert_bits(got, tree)
    assert got["opt"]["m"][1] is None and isinstance(got["pair"], Pair)
    assert ckpt.metadata(str(tmp_path / "c")) == {"step": 12, "note": "x"}
    bad = dict(tree, w=torch.zeros(5, 3))
    with pytest.raises(ValueError, match="checkpoint shape"):
        ckpt.restore(str(tmp_path / "c"), bad)


def test_store_format_is_the_jax_store_format(tmp_path):
    """The same tree through both stores: ``meta.msgpack`` byte for byte,
    the arrays equal, and each store restores the other's in bits."""
    import jax
    from repro.checkpoint import restore as jrestore
    from repro.checkpoint import save as jsave

    tree = _tree(np.random.default_rng(1), wide=np.int32)
    jtree = _jnp_tree(tree)
    assert store.tree_flatten(tree)[1] == str(jax.tree.structure(jtree))
    ckpt.save(str(tmp_path / "port"), tree, metadata={"step": 3})
    jsave(str(tmp_path / "jax"), jtree, metadata={"step": 3})
    assert ((tmp_path / "port" / "meta.msgpack").read_bytes()
            == (tmp_path / "jax" / "meta.msgpack").read_bytes())
    _assert_bits(jrestore(str(tmp_path / "port"), jtree), jtree, "jax <- port")
    _assert_bits(ckpt.restore(str(tmp_path / "jax"), tree), tree, "port <- jax")


MSGPACK_CASES = [
    None, True, False, 0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1,
    2**32, 2**64 - 1, -1, -32, -33, -128, -129, -32768, -32769, -2**31,
    -2**31 - 1, -2**63, 0.0, -0.0, 1.5, 1e300, float("inf"), "", "a" * 31,
    "a" * 32, "b" * 255, "c" * 256, "d" * 65536, "é∑", [], [1, [2, [3]]],
    list(range(16)), list(range(70000)), {}, {"a": 1},
    {f"k{i}": i for i in range(16)}, {f"k{i}": i for i in range(70000)},
    {"treedef": "PyTreeDef({'a': *})", "n_leaves": 3,
     "kinds": ["float32", "bfloat16", "int32"], "user": {"step": 10}},
]


@pytest.mark.parametrize("obj", MSGPACK_CASES,
                         ids=[f"case{i}" for i in range(len(MSGPACK_CASES))])
def test_msgpack_codec_matches_msgpack(obj):
    import msgpack

    want = msgpack.packb(obj)
    assert store.packb(obj) == want
    assert store.unpackb(want) == msgpack.unpackb(want)
    if isinstance(obj, float) and obj == 0.0:
        assert np.signbit(store.unpackb(want)) == np.signbit(obj)


def test_msgpack_codec_reads_what_msgpack_writes():
    """Tuples and bytes, and the float32 and bin formats the port never
    writes, as ``msgpack.unpackb`` reads them."""
    import msgpack

    for obj in [(1, 2), b"\x00\x01", b"x" * 300]:
        assert store.unpackb(msgpack.packb(obj)) == msgpack.unpackb(msgpack.packb(obj))
    single = msgpack.packb(1.25, use_single_float=True)
    assert store.unpackb(single) == msgpack.unpackb(single) == 1.25
    with pytest.raises(TypeError):
        store.packb({1, 2})


# ---------------------------------------------------------------------------
# the trainers
# ---------------------------------------------------------------------------


def _port_batches(ts):
    from repro_torch import configs
    from repro_torch.data import TokenPipeline

    cfg = configs.get_config("paper-resnet-proxy").smoke_variant()
    pipe = TokenPipeline(cfg, 4, 16, 0, "cpu")
    return [{k: v.numpy().astype(np.int32) for k, v in pipe.batch_at(t).items()}
            for t in ts]


class _JaxTrainer:
    """The JAX trainer's assembly at W = 1 (``repro.launch.train.main``
    with the port's defaults: RegTop-k at S = 0.01, mu 1, Adam at lr
    1e-3), on a mesh of Auto axes."""

    def __init__(self):
        import jax
        import jax.numpy as jnp
        from jax.sharding import AxisType

        from repro import configs as jconfigs
        from repro.core import distributed as jd
        from repro.core.sparsify import SparsifierConfig as JaxSparsifierConfig
        from repro.models import get_family
        from repro.optim import OptConfig as JaxOptConfig
        from repro.optim import make_optimizer

        cfg = jconfigs.get_config("paper-resnet-proxy").smoke_variant()
        self.mesh = jax.make_mesh((1, 1), ("data", "model"),
                                  axis_types=(AxisType.Auto, AxisType.Auto))
        dist = jd.DistConfig(
            sparsifier=JaxSparsifierConfig(kind="regtopk", sparsity=0.01, mu=1.0),
            optimizer=JaxOptConfig(kind="adam", learning_rate=1e-3),
            dp_axes=("data",))
        mod = get_family(cfg)
        asm = jd.assemble(mod, cfg, dist, self.mesh)
        self.params, _ = mod.init(jax.random.PRNGKey(0), cfg)
        self.opt_state = make_optimizer(dist.optimizer).init(self.params)
        self.sp, _ = jd.init_sparsifier_state(asm.plan, 1, self.mesh, ("data",),
                                              jnp.float32)
        self.step_fn = jax.jit(asm.train_step)
        self.losses = []

    def run(self, batches):
        import jax
        import jax.numpy as jnp

        with self.mesh:
            for b in batches:
                self.params, self.opt_state, self.sp, m = self.step_fn(
                    self.params, self.opt_state, self.sp,
                    jax.tree.map(jnp.asarray, b))
                self.losses.append(float(m["loss"]))

    def save(self, path, step):
        from repro.checkpoint import save

        save(f"{path}/params", self.params, metadata={"step": step})
        save(f"{path}/opt", self.opt_state)
        save(f"{path}/sparsifier", self.sp)

    def restore(self, path):
        from repro.checkpoint import restore

        self.params = restore(f"{path}/params", self.params)
        self.opt_state = restore(f"{path}/opt", self.opt_state)
        self.sp = restore(f"{path}/sparsifier", self.sp)


def _close(got, want, msg):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max(), err_msg=msg)


def _compare_to_jax(res, jt, losses=None):
    """The port's ``RunResult`` against the JAX trainer's state: params and
    eps to the tolerance, sent indices as sets and round counters exactly."""
    if losses is not None:
        np.testing.assert_allclose(res.losses, losses, rtol=RTOL)
    jparams = dict(tree_items(convert_tree(jt.params)))
    for path, leaf in tree_items(res.params):
        _close(leaf.numpy(), jparams[path], path)
    jsp = dict(tree_items(jt.sp))
    for path, st in tree_items(res.sp_state):
        js = jsp[path]
        np.testing.assert_array_equal(st.t.numpy(), np.asarray(js.t))
        _close(st.eps.numpy(), np.asarray(js.eps).reshape(st.eps.shape), path)
        np.testing.assert_array_equal(np.sort(st.sent_idx.numpy().reshape(-1)),
                                      np.sort(np.asarray(js.sent_idx).reshape(-1)),
                                      err_msg=path)


def convert_tree(tree):
    import jax

    return jax.tree.map(np.asarray, tree)


def _args(*flags):
    from repro_torch.launch import train

    return train.parse_args([*BASE, *flags])


def test_jax_checkpoint_resumes_in_the_port_and_back(tmp_path):
    """JAX: 2 steps, checkpointed as its trainer does. The port resumes it
    for 2 steps (``--resume``, then ``--checkpoint``) beside the JAX run's
    own 2 more steps on the same batches; the JAX package restores the
    port's checkpoint in bits, and both continue one more step."""
    from repro_torch.launch import train

    jt = _JaxTrainer()
    jt.run(_port_batches([0, 1]))
    jt.save(str(tmp_path / "jax"), 2)
    res = train.run(_args("--resume", str(tmp_path / "jax"), "--steps", "2",
                          "--checkpoint", str(tmp_path / "port")))
    jt.run(_port_batches([2, 3]))
    _compare_to_jax(res, jt, jt.losses[2:])
    # the JAX package reads what the port wrote, in bits
    from repro.checkpoint.store import metadata as jmetadata

    jt.restore(str(tmp_path / "port"))
    assert jmetadata(str(tmp_path / "port") + "/params") == {"step": 4}
    _assert_bits(convert_tree(jt.params), res.params, "params")
    _assert_bits(convert_tree(jt.opt_state), res.opt_state, "opt")
    _assert_bits(convert_tree(jt.sp),
                 convert.trainer_state_to_jax(res.sp_state, res.plan), "sparsifier")
    res2 = train.run(_args("--resume", str(tmp_path / "port"), "--steps", "1"))
    jt.run(_port_batches([4]))
    _compare_to_jax(res2, jt, jt.losses[4:])


RESUME_CASES = {
    "W1": ["--workers", "1", "--fastpath", "on"],
    "W4-round_robin-adaptive": ["--workers", "4", "--fastpath", "on",
                                "--participation", "round_robin:2",
                                "--adaptive-k", "1.0,0.001,0.012"],
}


def _compare_runs(got, want, msg):
    """Two port runs of one configuration: losses, params and eps to the
    tolerance; sent indices, round counters and the controller exactly."""
    np.testing.assert_allclose(got.losses, want.losses, rtol=RTOL, err_msg=msg)
    wp = dict(tree_items(want.params))
    for path, leaf in tree_items(got.params):
        _close(leaf.numpy(), wp[path].numpy(), f"{msg} {path}")
    gs, ws = got.sp_state, want.sp_state
    if isinstance(gs, tuple):
        for (path, a), (_, b) in zip(tree_items(gs[1]), tree_items(ws[1]), strict=True):
            assert (int(a.k), int(a.t)) == (int(b.k), int(b.t)), path
            np.testing.assert_allclose(float(a.err_ratio), float(b.err_ratio),
                                       rtol=RTOL, err_msg=path)
        gs, ws = gs[0], ws[0]
    for (path, a), (_, b) in zip(tree_items(gs), tree_items(ws), strict=True):
        assert torch.equal(a.t, b.t), path
        assert torch.equal(a.sent_idx.sort(-1).values, b.sent_idx.sort(-1).values), path
        _close(a.eps.numpy(), b.eps.numpy(), f"{msg} {path}.eps")


@pytest.mark.parametrize("case", list(RESUME_CASES))
def test_resumed_run_equals_the_unbroken_run(case, tmp_path):
    from repro_torch.launch import train

    flags = RESUME_CASES[case]
    whole = train.run(_args(*flags, "--steps", "4"))
    first = train.run(_args(*flags, "--steps", "2", "--checkpoint", str(tmp_path)))
    # the files hold the state they were written from, bit for bit
    _assert_bits(ckpt.restore(f"{tmp_path}/params", first.params), first.params)
    _assert_bits(ckpt.restore(f"{tmp_path}/opt", first.opt_state), first.opt_state)
    sp = convert.trainer_state_to_jax(first.sp_state, first.plan)
    _assert_bits(ckpt.restore(f"{tmp_path}/sparsifier", sp), sp)
    assert ckpt.metadata(f"{tmp_path}/params") == {"step": 2}
    rest = train.run(_args(*flags, "--steps", "2", "--resume", str(tmp_path)))
    joined = train.RunResult(first.losses + rest.losses, *rest[1:])
    _compare_runs(joined, whole, case)
    if "--participation" in flags:
        # the schedule's round counter carried over: the resumed run's
        # first round dropped the workers of round 2, not of round 0
        assert all(int(st.t.min()) == 4 for _, st in tree_items(rest.sp_state[0]))


def test_resume_refuses_another_layout(tmp_path):
    from repro_torch.launch import train

    train.run(_args("--workers", "2", "--steps", "1", "--checkpoint", str(tmp_path)))
    with pytest.raises(ValueError, match="checkpoint shape"):
        train.run(_args("--workers", "4", "--steps", "1", "--resume", str(tmp_path)))


def _rank(rank, world, store_path, out_dir):
    """A rank of the 2-rank run: 2 steps, checkpointed under out_dir."""
    import torch.distributed as dist

    from repro_torch.launch import mesh, train

    mesh.init_file_store(store_path, rank, world, "gloo")
    try:
        train.run(train.parse_args([*BASE, "--steps", "2", "--fastpath", "on",
                                    "--checkpoint", f"{out_dir}/ckpt"]),
                  mesh=mesh.make_host_groups())
    finally:
        dist.destroy_process_group()


def test_two_rank_checkpoint_resumes_on_one_process(tmp_path):
    """2 gloo ranks write a checkpoint after 2 steps (rank 0 writes the
    gathered [2, ...] state); ``--workers 2 --resume`` in this process
    continues it, and equals the one-card run's 4 steps to the tolerances."""
    from repro_torch.launch import mesh, train

    mesh.spawn(_rank, 2, (str(tmp_path / "store"), str(tmp_path)), timeout=120)
    flags = ["--workers", "2", "--fastpath", "on"]
    first = train.run(_args(*flags, "--steps", "2"))
    ranks_sp = convert.trainer_state_from_jax(
        ckpt.restore(f"{tmp_path}/ckpt/sparsifier",
                     convert.trainer_state_to_jax(first.sp_state, first.plan)),
        first.plan)
    for (path, a), (_, b) in zip(tree_items(ranks_sp), tree_items(first.sp_state),
                                 strict=True):
        assert a.eps.shape[0] == 2 and torch.equal(a.t, b.t), path
        assert torch.equal(a.sent_idx.sort(-1).values, b.sent_idx.sort(-1).values)
        _close(a.eps.numpy(), b.eps.numpy(), path)
    whole = train.run(_args(*flags, "--steps", "4"))
    rest = train.run(_args(*flags, "--steps", "2", "--resume", f"{tmp_path}/ckpt"))
    _compare_runs(train.RunResult(whole.losses[:2] + rest.losses, *rest[1:]),
                  whole, "ranks")


def test_trainer_state_layout_round_trips():
    """``convert.trainer_state_to_jax`` gives the JAX trainer's shapes and
    dtypes (``sparsifier_state_shapes``), and ``trainer_state_from_jax``
    undoes it."""
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.compat import make_mesh
    from repro.core import distributed as jd
    from repro_torch.core import distributed as td

    params = {"a": torch.zeros(4, 6), "b": {"c": torch.zeros(10)}}
    dist = td.DistConfig()
    plan = td.build_plan(params, 0.2, dist)
    st = td.init_sparsifier_state(plan, 3, "cpu")
    jplan = {"a": jd.LeafPlan((4, 6), (4, 6), 24, plan["a"].k, P(None)),
             "b": {"c": jd.LeafPlan((10,), (10,), 10, plan["b"]["c"].k, P(None))}}
    shapes, _ = jd.sparsifier_state_shapes(jplan, 3, make_mesh((1, 1), ("data", "model")),
                                           ("data",), jnp.float32)
    got = convert.trainer_state_to_jax(st, plan)
    for (path, a), (_, b) in zip(tree_items(got), tree_items(shapes), strict=True):
        for x, y in zip(a, b, strict=True):
            assert tuple(x.shape) == tuple(y.shape), path
            assert str(x.dtype).split(".")[-1] == str(np.dtype(y.dtype)), path
    back = convert.trainer_state_from_jax(got, plan)
    _assert_bits(back, st)


def _jax_state_template(amesh, W, sparsity=0.01):
    """The JAX trainer's sparsifier state (zeros) of paper-resnet-proxy's
    smoke variant on ``amesh``: ``sent_* [W, M, k]``."""
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro.core import distributed as jd
    from repro.models import get_family
    from repro.nn import sharding as jsh

    cfg = jconfigs.get_config("paper-resnet-proxy").smoke_variant()
    shapes, axes = jd.shapes_and_axes(get_family(cfg), cfg)
    specs = jsh.tree_specs(shapes, axes, amesh, None, ("data",))
    plan = jd.build_plan(shapes, specs, amesh, sparsity)
    return jd.init_sparsifier_state(plan, W, amesh, ("data",), jnp.float32)[0]


def test_trainer_state_layout_round_trips_on_model_shards():
    """At ``(data, model) = (3, 2)``: a state in the JAX layout (``eps [W,
    *shape]``, ``sent_* [W, M, k]``) becomes a row per (worker, shard),
    each row its shard's block flattened on its own (a leaf left whole
    twice), and comes back in bits; the shapes and dtypes are
    ``sparsifier_state_shapes``'."""
    import jax.numpy as jnp
    from jax.sharding import AbstractMesh

    from repro.core import distributed as jd
    from repro.nn import sharding as jsh
    from repro_torch.core import distributed as td

    rng = np.random.default_rng(5)
    shapes = {"a": (4, 6), "b": {"c": (10,)}, "d": (2, 8, 3)}
    axes = {"a": ("embed", "mlp"), "b": {"c": ("embed",)},
            "d": ("layers", "heads", "head_dim")}
    params = {"a": torch.zeros(4, 6), "b": {"c": torch.zeros(10)},
              "d": torch.zeros(2, 8, 3)}
    mesh = {"data": 3, "model": 2}
    plan = td.build_plan(params, 0.2, td.DistConfig(), axes=axes, mesh=mesh)
    amesh = AbstractMesh((3, 2), ("data", "model"))
    jshapes = {"a": jnp.zeros((4, 6)), "b": {"c": jnp.zeros(10)},
               "d": jnp.zeros((2, 8, 3))}
    jplan = jd.build_plan(jshapes, jsh.tree_specs(jshapes, axes, amesh), amesh, 0.2)
    want, _ = jd.sparsifier_state_shapes(jplan, 3, amesh, ("data",), jnp.float32)

    def leaf(p, s):
        M, k = 2, p.k
        return convert.CompactState(
            eps=torch.from_numpy(rng.standard_normal((3, *s)).astype(np.float32)),
            sent_vals=torch.from_numpy(rng.standard_normal((3, M, k)).astype(np.float32)),
            sent_g=torch.from_numpy(rng.standard_normal((3, M, k)).astype(np.float32)),
            sent_idx=torch.from_numpy(rng.integers(0, p.local_len, (3, M, k)).astype(np.int32)),
            sent_w=torch.ones(3, M, k), t=torch.tensor([4, 4, 4], dtype=torch.int32))

    jstate = {"a": leaf(plan["a"], shapes["a"]),
              "b": {"c": leaf(plan["b"]["c"], shapes["b"]["c"])},
              "d": leaf(plan["d"], shapes["d"])}
    ours = convert.trainer_state_from_jax(jstate, plan)
    assert ours["a"].eps.shape == (6, 12) and ours["b"]["c"].eps.shape == (6, 10)
    assert ours["d"].eps.shape == (6, 24) and ours["a"].t.tolist() == [4] * 6
    # row (w, m) of a is worker w's columns m*3 .. m*3+2, flattened row-major
    for w in range(3):
        for m in range(2):
            assert torch.equal(ours["a"].eps[2 * w + m],
                               jstate["a"].eps[w][:, 3 * m:3 * m + 3].reshape(-1))
            assert torch.equal(ours["d"].eps[2 * w + m],
                               jstate["d"].eps[w][:, 4 * m:4 * m + 4].reshape(-1))
            assert torch.equal(ours["b"]["c"].eps[2 * w + m], jstate["b"]["c"].eps[w])
            assert torch.equal(ours["a"].sent_idx[2 * w + m],
                               jstate["a"].sent_idx[w, m].long())
    back = convert.trainer_state_to_jax(ours, plan)
    _assert_bits(back, jstate)
    for (path, a), (_, b) in zip(tree_items(back), tree_items(want), strict=True):
        for x, y in zip(a, b, strict=True):
            assert tuple(x.shape) == tuple(y.shape), path
            assert str(x.dtype).split(".")[-1] == str(np.dtype(y.dtype)), path
    with pytest.raises(ValueError, match="2 model shards; the plan has 1"):
        convert.trainer_state_from_jax(jstate, td.build_plan(params, 0.2))


def test_model_parallel_checkpoint_restores_in_jax_and_back(tmp_path):
    """The port's ``--workers 4 --model-parallel 2 --checkpoint`` restores in
    ``repro.checkpoint.restore`` into the JAX trainer's state tree at
    ``(2, 2)`` (``sent_* [2, 2, k]``) in bits, and what the JAX package
    saves of it restores in the port, back to the run's own state."""
    from jax.sharding import AbstractMesh

    from repro.checkpoint import restore as jrestore
    from repro.checkpoint import save as jsave
    from repro_torch.launch import train

    res = train.run(_args("--workers", "4", "--model-parallel", "2", "--steps",
                          "2", "--fastpath", "on", "--checkpoint",
                          str(tmp_path / "port")))
    mine = convert.trainer_state_to_jax(res.sp_state, res.plan)
    template = _jax_state_template(AbstractMesh((2, 2), ("data", "model")), 2)
    got = jrestore(str(tmp_path / "port") + "/sparsifier", template)
    _assert_bits(convert_tree(got), mine, "sparsifier")
    assert all(tuple(np.shape(st.sent_idx))[:2] == (2, 2)
               for _, st in tree_items(convert_tree(got)))
    jsave(str(tmp_path / "jax") + "/sparsifier", got)
    back = convert.trainer_state_from_jax(
        ckpt.restore(str(tmp_path / "jax") + "/sparsifier", mine), res.plan)
    _assert_bits(back, res.sp_state, "round trip")
