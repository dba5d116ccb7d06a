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
"""
import pytest

from test_torch_dryrun import int64_extra, jax_cases, port_case

ARCHS = ("mixtral-8x7b", "deepseek-moe-16b")
CASES = {arch: f"{arch}:train_4k:8x1" for arch in ARCHS}


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    return jax_cases(tmp_path_factory, list(CASES.values()))


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
