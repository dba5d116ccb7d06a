"""The dry run's training step (``repro_torch.launch.dryrun.count_train``)
against the JAX dry run's ``lower_train`` at ``(8, 1)`` for the VLM and
the encoder-decoder: internvl2-1b (a patch prefix from the vision stub)
and whisper-tiny (cross-attention over the encoder's frames), each on its
smoke fields at ``train_4k``'s sequence and batch (the JAX side in one
subprocess of 8 host devices, ``tests/_torch_dryrun_jax.py``).

* FLOPs equal the HLO walker's to the FLOP (one worker's 32 rows in 8
  microbatches, forward and backward).
* ``argument_bytes`` equals ``argument_size_in_bytes`` but for the port's
  int64 tokens, labels and ``sent_idx``; the patches and frames are
  bf16 in both.
* The all-gather bytes equal the walker's, the all-reduce its 4 B.
"""
import pytest

from test_torch_dryrun import int64_extra, jax_cases, port_case

ARCHS = ("internvl2-1b", "whisper-tiny")
CASES = {arch: f"{arch}:train_4k:8x1" for arch in ARCHS}


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    return jax_cases(tmp_path_factory, list(CASES.values()))


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(jax_runs, monkeypatch, arch):
    rec, lay = port_case(monkeypatch, CASES[arch])
    want = jax_runs[CASES[arch]]
    assert lay.W == 8 and lay.rows == 32 and lay.dist.microbatches == 8
    assert rec["flops"] == want["flops"]
    assert not any("convolution" in k for k in rec["flops_by_op"])
    assert rec["mem"]["argument_bytes"] - int64_extra(lay) == (
        want["argument_bytes"])
    assert rec["collective_bytes"]["all-gather"] == (
        want["collective_bytes"]["all-gather"])
    assert rec["collective_bytes"]["all-reduce"] == 4 == (
        want["collective_bytes"]["all-reduce"])
