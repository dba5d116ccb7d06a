"""The port's cost model against the JAX package's.

``repro_torch.comm.cost`` is ``repro.comm.cost`` line for line, plain
arithmetic: on a grid of codecs x collectives x (L, k) x dp mesh shapes x
link models (scalar, uniform per-axis, a slow outer axis) x participants,
every integer must be equal and every predicted second ``==``. The
measured side counts the port's encoded buffers (``nbytes``) where the
JAX package counts ``jax.eval_shape``'s shapes.
"""
import itertools

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.comm import codec as jcodec
from repro.comm import cost as jcost
from repro_torch.comm import codec as tcodec
from repro_torch.comm import cost as tcost
import _torch_cores  # noqa: F401  (this worker's share of the cores)

CODECS = sorted(tcodec.CODECS)
COLLECTIVES = ["dense_allreduce", "sparse_allgather", "hierarchical"]
SHAPES = [(100, 7), (32768, 328), (4_458_752, 44_588)]
DP = [(8,), (1, 4), (2, 4), (2, 2, 2), (1,)]


def _models(n_axes, mod):
    ab = mod.AlphaBeta
    return [
        ab(),
        ab(alpha=2e-6, beta=5e-12),
        mod.LinkTopo.uniform(ab(), n_axes),
        mod.LinkTopo(tuple(ab(1e-5 * (i + 1), 1e-10 / (i + 1)) for i in range(n_axes))),
    ]


def _jax_payload_bytes(name, L, k):
    shapes = jax.eval_shape(
        lambda v, i: jcodec.get_codec(name).encode(v, i, L),
        jax.ShapeDtypeStruct((k,), jnp.float32),
        jax.ShapeDtypeStruct((k,), jnp.int32),
    )
    return jcost.payload_nbytes(shapes)


def _port_payload(name, L, k):
    """One worker's encoded payload (a worker axis of 1)."""
    return tcodec.get_codec(name).encode(
        torch.zeros(1, k), torch.zeros(1, k, dtype=torch.int64), L
    )


@pytest.mark.parametrize("collective", COLLECTIVES)
@pytest.mark.parametrize("name", CODECS)
def test_cost_functions_equal_jax(name, collective):
    for (L, k), dp in itertools.product(SHAPES, DP):
        n = 1
        for s in dp:
            n *= s
        parts = [None] + ([1.0, (n + 1) / 2, float(n)] if n > 1 else [])
        pb = tcost.payload_nbytes(_port_payload(name, L, k))
        assert pb == _jax_payload_bytes(name, L, k)
        for wb in (4, 2):
            for p in parts:
                assert tcost.pattern_axes(collective, L, float(pb), dp, wb, p) == (
                    jcost.pattern_axes(collective, L, float(pb), dp, wb, p))
                assert tcost.predicted_bytes(name, collective, L, k, dp, wb, p) == (
                    jcost.predicted_bytes(name, collective, L, k, dp, wb, p))
                for tm, jm in zip(_models(len(dp), tcost), _models(len(dp), jcost),
                                  strict=True):
                    te = tcost.predict(name, collective, L, k, dp, tm, wb, p)
                    je = jcost.predict(name, collective, L, k, dp, jm, wb, p)
                    assert (te.bytes_on_wire, te.n_messages) == (
                        je.bytes_on_wire, je.n_messages)
                    assert te.seconds == je.seconds
                    assert tcost.stage_seconds(
                        tcodec.get_codec(name), collective, L, k, dp, tm, wb, p
                    ) == jcost.stage_seconds(
                        jcodec.get_codec(name), collective, L, k, dp, jm, wb, p)


@pytest.mark.parametrize("name", CODECS)
def test_measured_bytes_count_the_buffers(name):
    """The measured side from the port's buffers equals the JAX package's
    from ``jax.eval_shape``, for every collective and mesh."""
    for L, k in SHAPES:
        shapes = jax.eval_shape(
            lambda v, i, L=L: jcodec.get_codec(name).encode(v, i, L),
            jax.ShapeDtypeStruct((k,), jnp.float32),
            jax.ShapeDtypeStruct((k,), jnp.int32),
        )
        tpay = _port_payload(name, L, k)
        for dp, coll, wb in itertools.product(DP, COLLECTIVES, (4, 2)):
            assert tcost.measured_bytes(coll, L, tpay, dp, wb) == (
                jcost.measured_bytes(coll, L, shapes, dp, wb))


@pytest.mark.parametrize("spec,axes", [
    ("inter:1e-5,1e-10;intra:1e-6,1e-11", ("pod", "data")),
    ("2e-5,3e-11", ("data",)),
    ("pod:1e-5,1e-9;data:1e-6,1e-11", ("pod", "data")),
    ("inter:1e-5,1e-10;intra:1e-6,1e-11", ("a", "b", "c")),
    ("intra:1e-6,1e-11", ("data",)),
])
def test_parse_link_topo_equals_jax(spec, axes):
    t, j = tcost.parse_link_topo(spec, axes), jcost.parse_link_topo(spec, axes)
    assert [(lk.alpha, lk.beta) for lk in t.links] == [
        (lk.alpha, lk.beta) for lk in j.links]
    assert (t.n_axes, t.is_uniform) == (j.n_axes, j.is_uniform)


@pytest.mark.parametrize("spec,axes", [
    ("inter:1e-5,1e-10", ("data",)),
    ("bogus:1e-5,1e-10", ("data",)),
    ("data:1e-5,1e-10;data:1e-5,1e-10", ("data",)),
    ("inter:1e-5,1e-10", ("pod", "data")),
    ("1e-5", ("data",)),
    ("", ("data",)),
    ("1e-5,1e-10", ()),
])
def test_parse_link_topo_errors_equal_jax(spec, axes):
    with pytest.raises(ValueError) as want:
        jcost.parse_link_topo(spec, axes)
    with pytest.raises(ValueError) as got:
        tcost.parse_link_topo(spec, axes)
    assert str(got.value) == str(want.value)


def test_link_model_types_equal_jax():
    assert tcost.AlphaBeta() == tcost.AlphaBeta(1e-5, 1e-11)
    assert (tcost.AlphaBeta().alpha, tcost.AlphaBeta().beta) == (
        jcost.AlphaBeta().alpha, jcost.AlphaBeta().beta)
    assert tcost.as_topo(tcost.AlphaBeta(), 3).n_axes == 3
    for bad, exc in ((tcost.LinkTopo.uniform(tcost.AlphaBeta(), 3), ValueError),
                     (object(), TypeError)):
        with pytest.raises(exc):
            tcost.as_topo(bad, 2)
    with pytest.raises(ValueError) as got:
        tcost.as_topo(tcost.LinkTopo.uniform(tcost.AlphaBeta(), 3), 2)
    with pytest.raises(ValueError) as want:
        jcost.as_topo(jcost.LinkTopo.uniform(jcost.AlphaBeta(), 3), 2)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="at least one"):
        tcost.LinkTopo(())
    with pytest.raises(ValueError) as got:
        tcost.pattern_axes("ring", 10, 8.0, (2,))
    with pytest.raises(ValueError) as want:
        jcost.pattern_axes("ring", 10, 8.0, (2,))
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as got:
        tcost.predicted_bytes("coo_fp32", "sparse_allgather", 10, 2, (4,), participants=9.0)
    with pytest.raises(ValueError) as want:
        jcost.predicted_bytes("coo_fp32", "sparse_allgather", 10, 2, (4,), participants=9.0)
    assert str(got.value) == str(want.value)
