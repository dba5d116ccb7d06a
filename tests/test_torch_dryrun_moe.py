"""The dry run's training step (``repro_torch.launch.dryrun.count_train``)
against the JAX dry run's ``lower_train`` at ``(8, 1)`` for the two MoE
configs, mixtral-8x7b (sliding windows, no shared experts) and
deepseek-moe-16b (shared experts), each on its smoke fields at
``train_4k``'s sequence and batch and the published group size of 4096
tokens (the JAX side in one subprocess of 8 host devices,
``tests/_torch_dryrun_jax.py``).

* FLOPs equal the HLO walker's to the FLOP (the GShard dispatch and
  combine einsums, the router, the experts, attention and the head).
* ``argument_bytes`` equals ``argument_size_in_bytes`` but for the port's
  int64 tokens, labels and ``sent_idx``.
* The all-gather bytes equal the walker's but for the gathers GSPMD adds
  inside the router's ``top_k`` (it gathers the router's scores across
  the 8 devices; the port has no partitioner), which the JAX side names
  by their op and leaves out; the all-reduce is the loss mean's 4 B.

With a model axis (deepseek-moe-16b at ``(4, 2)``, in both of
``moe_parallelism``'s layouts) the rank trains tensor parallel: its
``argument_bytes`` equal JAX's but for the int64 extras, its
``rank_bytes`` are its blocks' parameters, Adam's moments and gradient
plus the batch, its state rows and Adam's step, the model group
all-reduces activations, and the whole forward that a family without
tensor parallelism would run at this layout peaks higher and counts more
FLOPs.
"""
import pytest

from test_torch_dryrun import (input_specs_batch, int64_extra, jax_cases,
                               port_case, rows_bytes)
import _torch_cores  # noqa: F401  (this worker's share of the cores)

ARCHS = ("mixtral-8x7b", "deepseek-moe-16b")
CASES = {arch: f"{arch}:train_4k:8x1" for arch in ARCHS}
MODEL_AXIS_CASES = {
    "tensor": "deepseek-moe-16b:train_4k:4x2",
    "expert": "deepseek-moe-16b:train_4k:4x2:moe_parallelism=expert",
}


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    return jax_cases(tmp_path_factory, [*CASES.values(),
                                        *MODEL_AXIS_CASES.values()])


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(jax_runs, monkeypatch, arch):
    rec, lay = port_case(monkeypatch, CASES[arch])
    want = jax_runs[CASES[arch]]
    assert lay.W == 8 and lay.rows == 32 and lay.cfg.moe_group_size == 4096
    assert rec["flops"] == want["flops"]
    assert rec["mem"]["argument_bytes"] - int64_extra(lay) == (
        want["argument_bytes"])
    router = (want["collective_bytes"]["all-gather"]
              - want["all_gather_without_router"])
    assert router > 0
    assert rec["collective_bytes"]["all-gather"] == (
        want["all_gather_without_router"])
    assert rec["collective_bytes"]["all-reduce"] == 4 == (
        want["collective_bytes"]["all-reduce"])


@pytest.mark.parametrize("layout", list(MODEL_AXIS_CASES))
def test_model_axis_is_tensor_parallel(jax_runs, monkeypatch, layout):
    from repro_torch.core import distributed as td
    from repro_torch.launch import dryrun
    from repro_torch.models import lm
    from repro_torch.nn.sharding import shard_params
    from repro_torch.tree import tree_leaves, tree_map

    case = MODEL_AXIS_CASES[layout]
    rec, lay = port_case(monkeypatch, case)
    assert lay.W == 4 and lay.cfg.moe_parallelism == layout
    assert rec["mem"]["argument_bytes"] - int64_extra(lay) == (
        jax_runs[case]["argument_bytes"])
    specs = tree_map(lambda p: p.spec, lay.plan)
    # the experts' width (dim 3 of [L, E, D, F]) or the experts (dim 1)
    mlp = lay.plan["layers"]["mlp"]
    assert td.split_dim(mlp["wg"]) == (3 if layout == "tensor" else 1)
    assert td.split_dim(mlp["router"]) is None
    local = shard_params(lay.params, specs, 0, 2)
    # bf16 params, bf16 moments and a bf16 gradient an element (the dry
    # run's state dtype for deepseek-moe-16b)
    assert (lay.cfg.dtype, lay.dist.optimizer.moment_dtype,
            lay.dist.state_dtype) == ("bfloat16",) * 3
    per = 2 + 2 + 2 + 2
    n_local = sum(x.numel() for x in tree_leaves(local))
    n_whole = sum(x.numel() for x in tree_leaves(lay.params))
    assert rec["rank_bytes"] - per * n_local == (  # and Adam's step
        dryrun._tree_bytes(input_specs_batch(lay)) + rows_bytes(lay) + 4)
    assert rec["rank_collective_bytes"]["all-reduce:model"] > 0
    monkeypatch.setattr(lm, "TENSOR_PARALLEL", lm.TENSOR_PARALLEL - {"moe"})
    whole, _ = port_case(monkeypatch, case)
    assert "all-reduce:model" not in whole["rank_collective_bytes"]
    assert whole["rank_bytes"] - rec["rank_bytes"] == per * (n_whole - n_local)
    assert rec["mem"]["peak_bytes"] < whole["mem"]["peak_bytes"]
    assert rec["flops"] < whole["flops"]
