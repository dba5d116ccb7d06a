"""The port's shard forms across ranks against the JAX package's shard
forms, on shared payloads.

The port runs N ranks over gloo on the CPU (``torch.multiprocessing``,
one spawn per world size, every case of that size in it); each rank
encodes its own worker's ``(vals, idx)`` and calls ``shard`` or
``shard_coord`` over the process groups of ``repro_torch.launch.mesh``.
The JAX package runs the same collective's ``shard`` form in this process
under a named ``jax.vmap`` over the N stacked payloads: axis ``"data"``
on the host layout, nested ``("pod", "data")`` vmaps on the multi-pod
layouts (2, 1) and (2, 2). Every rank's ``agg`` (and ``den`` under
coordinate weighting) must equal JAX's:

* in f32 bits wherever the reduction is the rank-ordered scatter-add
  (``sparse_allgather``, and ``hierarchical``'s gathered stage) or an
  ``all_reduce`` over groups of at most two ranks (a + b == b + a);
* to rtol 1e-6 where ``all_reduce`` sums four ranks in the backend's
  order (``dense_allreduce`` at N = 4), and then every rank must still
  hold the same bits.

A partial round (``participation=``) takes the same
checks: each rank passes its mask entry at its worker index (the rank,
outermost axis slowest) and the participant weight ``1/|P_t|``, as every
JAX worker passes its entry at ``worker_index`` over the dp axes.

The rank bodies are module-level functions and this file imports ``jax``
and ``repro`` only inside the tests, so a spawned rank loads no JAX.
The legacy helpers ``allgather_scatter`` and ``allreduce_dense`` are held
the same way. Each process group starts from a file under ``tmp_path``
(no port), and the spawn waits at most 120 s.
"""
import numpy as np
import pytest
import torch

L, K, SEED = 1000, 16, 3  # L >= 2^7: coo_idx_delta sends int16 deltas
CODECS = ("coo_fp32", "coo_idx_delta", "bitmap_dense", "coo_q8")
WEIGHTINGS = ("worker", "coordinate")
# (collective, layout): "host" is one dp axis "data" of N; "pods" is
# ("pod", "data") = (2, N/2)
LAYOUTS = (
    ("sparse_allgather", "host"),
    ("dense_allreduce", "host"),
    ("hierarchical", "pods"),
    ("sparse_allgather", "pods"),
)
CASES = [
    (n, coll, layout, codec, weighting)
    for n in (2, 4)
    for coll, layout in LAYOUTS
    for codec in CODECS
    for weighting in WEIGHTINGS
]
# a partial round's mask per world size: at N = 4 it drops rank 1, which on
# the (2, 2) pods layout sits third in the gathered stack (the pod index
# varies fastest there), so a rank that read its stack position instead of
# its worker index would silence the wrong payload
MASKS = {2: [1.0, 0.0], 4: [1.0, 0.0, 1.0, 1.0]}
PART_CASES = [
    (n, coll, layout, codec, weighting)
    for n in (2, 4)
    for coll, layout in LAYOUTS
    for codec in ("coo_fp32", "coo_q8")
    for weighting in WEIGHTINGS
]


def _inputs(n):
    """Each worker's ``(vals [K], idx [K])``: distinct indices, the last
    two slots the ``(+0.0, index 0)`` padding, and worker 0 also sending a
    real value at index 0."""
    rng = np.random.default_rng(SEED + n)
    vals = rng.standard_normal((n, K)).astype(np.float32)
    idx = np.stack([rng.choice(np.arange(1, L), K, replace=False)
                    for _ in range(n)]).astype(np.int32)
    vals[:, -2:], idx[:, -2:] = 0.0, 0
    idx[0, 0] = 0
    return vals, idx


def _shard_rank(rank, world, store, out_dir):
    """One rank: every (layout, collective, codec, weighting) case of this
    world size, results saved to ``out_dir/rank{rank}.pt``."""
    import torch.distributed as dist

    from repro_torch.comm import get_codec, get_collective, worker_index
    from repro_torch.core import allgather_scatter, allreduce_dense
    from repro_torch.launch import mesh

    mesh.init_file_store(store, rank, world, "gloo")
    try:
        layouts = {"host": mesh.make_host_groups(),
                   "pods": mesh.make_host_groups(multi_pod=True)}
        vals, idx = _inputs(world)
        out = {}
        for n, coll, layout, codec, weighting in CASES:
            if n != world:
                continue
            cd, groups = get_codec(codec), layouts[layout].groups
            payload = cd.encode(torch.from_numpy(vals[rank:rank + 1]),
                                torch.from_numpy(idx[rank:rank + 1]).long(), L)
            c = get_collective(coll)
            if weighting == "coordinate":
                res = c.shard_coord(cd, payload, L, groups, 1.0 / world)
            else:
                res = (c.shard(cd, payload, L, groups, 1.0 / world),)
            out[(coll, layout, codec, weighting)] = res
        for n, coll, layout, codec, weighting in PART_CASES:
            if n != world:
                continue
            cd, groups = get_codec(codec), layouts[layout].groups
            payload = cd.encode(torch.from_numpy(vals[rank:rank + 1]),
                                torch.from_numpy(idx[rank:rank + 1]).long(), L)
            mask = torch.tensor(MASKS[world])
            m = mask[worker_index(layouts[layout])]
            w_part = torch.ones(()) / mask.sum()
            c = get_collective(coll)
            fn = c.shard_coord if weighting == "coordinate" else c.shard
            res = fn(cd, payload, L, groups, w_part, participation=m)
            out[("partial", coll, layout, codec, weighting)] = (
                res if isinstance(res, tuple) else (res,))
        v = torch.from_numpy(vals[rank])
        i = torch.from_numpy(idx[rank]).long()
        groups = layouts["host"].groups
        out["allgather_scatter"] = allgather_scatter(v, i, L, groups, 1.0 / world)
        out["allreduce_dense"] = allreduce_dense(
            torch.zeros(L).index_add_(0, i, v), groups, 1.0 / world)
        torch.save(out, f"{out_dir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks_out(tmp_path_factory):
    """World size -> every rank's results, one spawn per size."""
    from repro_torch.launch import mesh

    out = {}
    for n in (2, 4):
        d = tmp_path_factory.mktemp(f"shard{n}")
        mesh.spawn(_shard_rank, n, (str(d / "store"), str(d)), timeout=120)
        out[n] = [torch.load(d / f"rank{r}.pt") for r in range(n)]
    return out


def _jax_shard(n, coll, layout, codec, weighting, mask=None):
    """The JAX package's shard form over the N stacked payloads under
    named vmaps: one ``[L]`` result (or ``(agg, den)``) per worker, in
    worker order. With ``mask`` each worker passes its own entry (by
    ``worker_index`` over the dp axes) and the participant weight."""
    import jax
    import jax.numpy as jnp

    from repro.comm import codec as jcodec
    from repro.comm import collectives as jcoll
    from repro.comm import worker_index

    vals, idx = _inputs(n)
    cd, c = jcodec.get_codec(codec), jcoll.get_collective(coll)
    stacked = jax.tree.map(
        lambda *x: jnp.stack(x),
        *(cd.encode(jnp.asarray(vals[w]), jnp.asarray(idx[w]), L)
          for w in range(n)))
    fn = c.shard_coord if weighting == "coordinate" else c.shard
    axes = ("data",) if layout == "host" else ("pod", "data")
    sizes = (n,) if layout == "host" else (2, n // 2)
    if mask is None:
        def one(p):
            return fn(cd, p, L, axes, 1.0 / n)
    else:
        jmask = jnp.asarray(mask, jnp.float32)
        w_part = 1.0 / jnp.maximum(jmask.sum(), 1.0)

        def one(p):
            return fn(cd, p, L, axes, w_part,
                      participation=jmask[worker_index(axes, sizes)])
    per_worker = jax.vmap(one, axis_name="data")
    if layout == "pods":
        per_worker = jax.vmap(per_worker, axis_name="pod")
        stacked = jax.tree.map(
            lambda x: x.reshape((2, n // 2) + x.shape[1:]), stacked)
    res = jax.jit(per_worker)(stacked)
    res = res if isinstance(res, tuple) else (res,)
    return [np.asarray(r).reshape(n, L) for r in res]


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


@pytest.mark.parametrize("n,coll,layout,codec,weighting", CASES)
def test_shard_form_matches_jax_shard_form(ranks_out, n, coll, layout, codec,
                                           weighting):
    want = _jax_shard(n, coll, layout, codec, weighting)
    got = [ranks_out[n][r][(coll, layout, codec, weighting)] for r in range(n)]
    # the largest group an all_reduce sums over in this case
    summed = {"dense_allreduce": n, "hierarchical": n // 2}.get(coll, 1)
    for i, name in enumerate(("agg", "den")[:len(want)]):
        for r in range(n):
            g = got[r][i].numpy()
            assert g.shape == (L,) and g.dtype == np.float32
            np.testing.assert_array_equal(
                _bits(g), _bits(got[0][i]), err_msg=f"{name}: rank {r} vs rank 0")
            if summed <= 2:
                np.testing.assert_array_equal(
                    _bits(g), _bits(want[i][r]), err_msg=f"{name}, rank {r}")
            else:
                np.testing.assert_allclose(
                    g, want[i][r], rtol=1e-6, atol=0, err_msg=f"{name}, rank {r}")
    assert np.count_nonzero(want[0][0]) > K  # the workers' payloads landed


@pytest.mark.parametrize("n,coll,layout,codec,weighting", PART_CASES)
def test_partial_shard_form_matches_jax_shard_form(ranks_out, n, coll, layout,
                                                   codec, weighting):
    """A partial round: each rank passes its own mask entry, read at its
    worker index, and the participant weight; every rank's result against
    JAX's shard form under the same mask, with the tolerances above."""
    want = _jax_shard(n, coll, layout, codec, weighting, MASKS[n])
    got = [ranks_out[n][r][("partial", coll, layout, codec, weighting)]
           for r in range(n)]
    summed = {"dense_allreduce": n, "hierarchical": n // 2}.get(coll, 1)
    for i, name in enumerate(("agg", "den")[:len(want)]):
        for r in range(n):
            g = got[r][i].numpy()
            np.testing.assert_array_equal(
                _bits(g), _bits(got[0][i]), err_msg=f"{name}: rank {r} vs rank 0")
            if summed <= 2:
                np.testing.assert_array_equal(
                    _bits(g), _bits(want[i][r]), err_msg=f"{name}, rank {r}")
            else:
                np.testing.assert_allclose(
                    g, want[i][r], rtol=1e-6, atol=0, err_msg=f"{name}, rank {r}")
    # the dropped worker's coordinates (none other sent them) carry nothing
    vals, idx = _inputs(n)
    live = np.asarray(MASKS[n]) > 0
    only = np.setdiff1d(idx[~live], idx[live])
    assert only.size and not np.any(got[0][0].numpy()[only])


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("helper", ["allgather_scatter", "allreduce_dense"])
def test_legacy_helpers_match_jax(ranks_out, helper, n):
    """``allgather_scatter`` (``coo_fp32`` through ``SparseAllgather.shard``)
    and ``allreduce_dense`` (of each worker's dense vector) against the JAX
    package's under ``jax.vmap(axis_name="data")``: bits, but to rtol 1e-6
    where ``all_reduce`` sums four ranks."""
    import jax
    import jax.numpy as jnp

    from repro.core import allgather_scatter, allreduce_dense

    vals, idx = _inputs(n)
    if helper == "allgather_scatter":
        fn = jax.vmap(lambda v, i: allgather_scatter(v, i, L, ("data",), 1.0 / n),
                      axis_name="data")
        want = np.asarray(jax.jit(fn)(jnp.asarray(vals), jnp.asarray(idx)))
    else:
        ghat = jax.vmap(lambda v, i: jnp.zeros(L).at[i].add(v))(
            jnp.asarray(vals), jnp.asarray(idx))
        fn = jax.vmap(lambda g: allreduce_dense(g, ("data",), 1.0 / n),
                      axis_name="data")
        want = np.asarray(jax.jit(fn)(ghat))
    for r in range(n):
        got = ranks_out[n][r][helper].numpy()
        np.testing.assert_array_equal(_bits(got), _bits(ranks_out[n][0][helper]))
        if helper == "allreduce_dense" and n > 2:
            np.testing.assert_allclose(got, want[r], rtol=1e-6, atol=0)
        else:
            np.testing.assert_array_equal(_bits(got), _bits(want[r]))
