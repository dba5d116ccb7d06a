"""The int32 wire's length limit: ``build_plan`` refuses a leaf (or a
model shard's block) of ``MAX_WIRE_LEN`` (2**31) elements or more on a
codec that sends int32 indices, before anything is allocated; the JAX
package's int32 wire would wrap index ``2**31 + 5`` to ``-2147483643``
(``repro.comm.codec``'s ``idx.astype(jnp.int32)``), which is shown here
on the port's own encode. Everything runs on meta tensors."""
import dataclasses

import pytest
import torch

from repro_torch.comm.codec import CODECS, MAX_WIRE_LEN, get_codec
from repro_torch.core import distributed as td
from repro_torch.core.sparsify import SparsifierConfig
import _torch_cores  # noqa: F401  (this worker's share of the cores)

LONG = (3, 2**30)  # 3 * 2**30 elements: past 2**31
S = 0.001
INT32_CODECS = ("coo_fp32", "coo_idx_delta", "coo_q8")


def _dist(**kw):
    return td.DistConfig(sparsifier=SparsifierConfig(kind="regtopk", sparsity=S),
                         **kw)


def _leaf(shape=LONG):
    return {"w": torch.empty(shape, device="meta")}


def test_the_int32_codecs_are_the_coo_ones():
    assert sorted(n for n, c in CODECS.items() if c.int32_indices) == sorted(
        INT32_CODECS)
    assert MAX_WIRE_LEN == 2**31


def test_an_int32_index_past_the_limit_wraps():
    """What the refusal prevents: the COO wire's int32 index wraps."""
    idx = torch.tensor([[2**31 + 5]])
    payload = get_codec("coo_fp32").encode(torch.ones(1, 1), idx, 2**31 + 6)
    assert get_codec("coo_fp32").decode(payload, 2**31 + 6)[1].item() == (
        -2147483643)


@pytest.mark.parametrize("codec", INT32_CODECS)
def test_build_plan_refuses_a_long_leaf_on_an_int32_codec(codec):
    with pytest.raises(ValueError, match=r"MAX_WIRE_LEN = 2\*\*31") as e:
        td.build_plan(_leaf(), S, _dist(codec=codec))
    msg = str(e.value)
    assert "3221225472 elements" in msg and repr(codec) in msg
    assert "bitmap_dense" in msg and "model axis" in msg


def test_build_plan_refuses_under_auto_when_it_picks_an_int32_codec():
    with pytest.raises(ValueError, match="MAX_WIRE_LEN") as e:
        td.build_plan(_leaf(), S, _dist(codec="auto", collective="auto"),
                      workers=4)
    assert any(repr(c) in str(e.value) for c in INT32_CODECS)


@pytest.mark.parametrize("dist", [
    _dist(codec="bitmap_dense"),
    _dist(collective="dense_allreduce"),
    td.DistConfig(sparsifier=SparsifierConfig(kind="none")),
], ids=["bitmap_dense", "dense_allreduce", "kind-none"])
def test_a_wire_without_int32_indices_plans_the_long_leaf(dist):
    p = td.build_plan(_leaf(), S, dist)["w"]
    assert p.local_len == 3 * 2**30 and p.global_shape == LONG
    assert not p.fused


@pytest.mark.parametrize("codec", INT32_CODECS)
def test_a_model_axis_that_splits_the_leaf_below_the_limit_plans_it(codec):
    """Split in two by a model axis of 2, each block has 1.5 * 2**30
    elements: planned as a plan without the guard plans it."""
    axes = {"w": (None, "mlp")}
    mesh = {"data": 1, "model": 2}
    got = td.build_plan(_leaf(), S, _dist(codec=codec), axes=axes,
                        mesh=mesh)["w"]
    want = td.build_plan(_leaf(), S, axes=axes, mesh=mesh)["w"]
    assert got == want._replace(fused=got.fused)
    assert got.local_shape == (3, 2**29) and got.shards == 2
    assert got.local_len < MAX_WIRE_LEN


@pytest.mark.parametrize("codec", INT32_CODECS)
def test_a_leaf_one_below_the_limit_plans_as_before(codec):
    n = MAX_WIRE_LEN - 1
    p = td.build_plan(_leaf((n,)), S, _dist(codec=codec))["w"]
    assert p.local_len == n and p.k == -(-n // 1000)


def test_the_train_step_refuses_a_plan_built_without_dist():
    """A plan built without a ``DistConfig`` has met no codec: the step
    builder checks each leaf's wire against the limit before a round."""
    plan = td.build_plan(_leaf(), S)
    with pytest.raises(ValueError, match="MAX_WIRE_LEN"):
        td.make_sparsify_aggregate(plan, _dist(), 2)
    td.make_sparsify_aggregate(plan, _dist(codec="bitmap_dense"), 2)


def test_the_dry_run_reports_the_refusal_as_a_fail(monkeypatch, capsys,
                                                   tmp_path):
    """phi3-medium-14b's stacked MLP leaves (3.67e9 elements) on a layout
    with no model axis to split them: a ``FAIL`` line naming the limit,
    and the sweep ends with its count."""
    from repro_torch.launch import dryrun

    monkeypatch.setattr(dryrun.meshlib, "production_shape",
                        lambda multi_pod=False: {"data": 1, "model": 1})
    rc = dryrun.main(["--arch", "phi3-medium-14b", "--shape", "train_4k",
                      "--out", str(tmp_path / "d.jsonl")])
    out = capsys.readouterr().out
    assert rc == 1
    fail = [line for line in out.splitlines() if line.startswith("FAIL")]
    assert len(fail) == 1 and "phi3-medium-14b x train_4k x 1x1" in fail[0]
    assert "MAX_WIRE_LEN" in fail[0]
    assert out.rstrip().endswith("dry-run complete; 1 failures")
    assert not (tmp_path / "d.jsonl").exists()


@pytest.mark.parametrize("field", [{"fastpath": "on"},
                                   {"weighting": "coordinate"},
                                   {"collective": "hierarchical"}],
                         ids=lambda f: next(iter(f)))
def test_other_fields_keep_the_refusal(field):
    with pytest.raises(ValueError, match="MAX_WIRE_LEN"):
        td.build_plan(_leaf(), S, dataclasses.replace(_dist(), **field))
