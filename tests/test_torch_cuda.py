"""Device routing of the port's kernel wrappers, and the tests that need an
NVIDIA card (marker ``cuda``; they skip without one).

This file imports neither ``jax`` nor ``repro``, so it also runs on a
machine that has only the port's dependencies:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import DistributedSim, SparsifierConfig
from repro_torch.core import selectors
from repro_torch.kernels import block_topk as bt
from repro_torch.kernels import fused_encode as fe
from repro_torch.kernels import ops
from repro_torch.kernels import regtopk_score as rs
from repro_torch.kernels import threshold_topk as tt
import _torch_cores  # noqa: F401  (this worker's share of the cores)

KW = dict(omega=0.125, mu=1.0, q=1e9, m=16)
SELECT_M = [1, 8, 16, 36, 128, 257, 512, 8192]  # the radix select at every depth


def _tiles(device, W=3, n=3 * 8192 + 17, seed=5, nan=None):
    """Worker-batched tiles; ``nan`` puts one NaN ("one") or only NaN
    ("tile") into tile 1 of worker 1's gradient."""
    rng = np.random.default_rng(seed)
    xs = [
        3.0 * rng.standard_normal((W, n)),
        3.0 * rng.standard_normal((W, n)),
        rng.random((W, n)) > 0.5,
        3.0 * rng.standard_normal((W, n)),
    ]
    if nan == "one":
        xs[0][1, 8192 + 5] = np.nan
    elif nan == "tile":
        xs[0][1, 8192:16384] = np.nan
    return [
        ops._tile(torch.tensor(x, dtype=torch.float32, device=device))[0]
        for x in xs
    ]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: a CUDA kernel has no CPU mode")


def test_cpu_tensor_takes_the_plain_version():
    xs = _tiles("cpu")
    before = fe.fused_candidates.launches
    got = fe.fused_candidates(*xs, y=1.0, **KW)
    want = fe.fused_candidates_ref(*xs, y=1.0, **KW)
    assert fe.fused_candidates.launches == before
    for g, w in zip(got, want, strict=True):
        assert torch.equal(g, w)


def test_other_devices_raise():
    x = torch.zeros(1, 8, 1024, device="meta")
    with pytest.raises(ValueError, match="no fused_candidates kernel"):
        fe.fused_candidates(x, x, x, x, y=1.0, **KW)


@pytest.mark.cuda
@pytest.mark.parametrize("nan", [None, "one", "tile"])
@pytest.mark.parametrize("y", [1.0, 2.0])
def test_kernel_matches_plain_version_bit_for_bit(card, y, nan):
    xs = _tiles("cuda", nan=nan)
    before = fe.fused_candidates.launches
    got = fe.fused_candidates(*xs, y=y, **KW)
    assert fe.fused_candidates.launches == before + 1
    want = fe.fused_candidates_ref(*xs, y=y, **KW)
    torch.cuda.synchronize()
    for g, w in zip(got, want, strict=True):
        torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)
    if nan is not None:
        assert torch.isnan(got[0][1, 1]).all()


def _unaligned(t):
    """A contiguous copy of ``t`` starting 4 bytes past a 16-byte boundary
    (the kernel's scalar loop)."""
    view = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:]
    return view.view_as(t).copy_(t)


@pytest.mark.cuda
@pytest.mark.parametrize("nan,aligned", [(None, True), ("one", True), (None, False)])
@pytest.mark.parametrize("y", [1.0, 2.0])
def test_score_kernel_matches_plain_version_bit_for_bit(card, y, nan, aligned):
    xs = _tiles("cuda", nan=nan)
    if not aligned:
        xs = [_unaligned(x) for x in xs]
        assert xs[0].data_ptr() % 16 == 4 and xs[0].is_contiguous()
    kw = dict(omega=0.125, mu=1.0, q=1e9, y=y)
    before = rs.regtopk_score.launches
    got = rs.regtopk_score(*xs, **kw)
    assert rs.regtopk_score.launches == before + 1
    want = rs.regtopk_score_ref(*xs, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
    assert torch.isnan(got).any() == (nan is not None)


@pytest.mark.cuda
def test_simulator_fastpath_on_equals_off_on_the_card(card):
    """RegTop-k with the score kernel and with the plain chain: the same
    masks and the same model, bit for bit, one launch per round."""
    rng = np.random.default_rng(0)
    X = torch.tensor(rng.standard_normal((4, 50, 300)), dtype=torch.float32,
                     device="cuda")
    yv = torch.tensor(rng.standard_normal((4, 50)), dtype=torch.float32,
                      device="cuda")

    def grad_fn(theta, widx):
        r = torch.einsum("ndj,j->nd", X[widx], theta) - yv[widx]
        return torch.einsum("ndj,nd->nj", X[widx], r) / 25.0

    out = {}
    for mode in ("off", "on"):
        sim = DistributedSim(grad_fn, 4, 300,
                             SparsifierConfig(kind="regtopk", sparsity=0.1, mu=4.0),
                             aggregation="sparse_allgather", fastpath=mode)
        before = rs.regtopk_score.launches
        out[mode] = sim.run(torch.zeros(300), 30,
                            trace_state_fn=lambda s: s.worker_states.s_prev)
        launched = rs.regtopk_score.launches - before
        assert launched == (30 if mode == "on" else 0)
    assert torch.equal(out["on"][1], out["off"][1])
    assert torch.equal(out["on"][0].theta, out["off"][0].theta)


def _score_tiles(W=3, n=3 * 8192 + 17, seed=9, case=None):
    """``|3 N(0, 1)|`` scores tiled to ``[W, rows, 1024]`` on the card;
    ``case``: "ties" (quarters), "nan" (one NaN in tile 1 of worker 1),
    "exhausted" (tile 1 of worker 1 holds 3 scores above -inf)."""
    s = np.abs(3.0 * np.random.default_rng(seed).standard_normal((W, n)))
    if case == "ties":
        s = np.rint(4.0 * s) / 4.0
    elif case == "nan":
        s[1, 8192 + 5] = np.nan
    elif case == "exhausted":
        s[1, 8192:16384] = -np.inf
        s[1, [8192 + 9, 8192 + 700, 16383]] = [2.0, 5.0, 2.0]
    return ops._tile(torch.tensor(s, dtype=torch.float32, device="cuda"))[0]


def _equal(got, want):
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


@pytest.mark.cuda
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("case", [None, "ties", "nan"])
def test_count_and_max_kernels_match_plain_versions(card, case, aligned):
    tiles = _score_tiles(case=case)
    if not aligned:
        tiles = _unaligned(tiles)
    before = (tt.count_above.launches, tt.global_max.launches)
    gm = tt.global_max(tiles)
    taus = [torch.full((3,), v, device="cuda") for v in (0.0, 1.7, float("nan"))]
    counts = [tt.count_above(tiles, tau) for tau in taus]
    assert (tt.count_above.launches, tt.global_max.launches) == (
        before[0] + 3, before[1] + 1)
    torch.cuda.synchronize()
    _equal(gm, tt.global_max_ref(tiles))
    assert torch.isnan(gm[1]) == (case == "nan")
    for tau, c in zip(taus, counts, strict=True):
        assert torch.equal(c, tt.count_above_ref(tiles, tau))


@pytest.mark.cuda
@pytest.mark.parametrize("case", [None, "ties", "nan"])
def test_threshold_mask_on_the_card_matches_plain_and_selector(card, case):
    """The kernel-driven bisection: no host sync, the plain version's
    mask and, per worker, the plain selector's, bit for bit."""
    tiles = _score_tiles(case=case)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        mask = tt.threshold_topk_mask(tiles, 300)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    _equal(mask, tt.threshold_topk_mask_ref(tiles, 300))
    if case != "nan":
        flat = tiles.reshape(3, -1)
        assert torch.equal(mask.reshape(3, -1),
                           selectors.threshold_topk_mask(flat, 300))


@pytest.mark.cuda
@pytest.mark.parametrize("m", SELECT_M)
@pytest.mark.parametrize("case", [None, "ties", "nan", "exhausted"])
def test_block_topk_kernel_matches_plain_version(card, case, m):
    tiles = _score_tiles(case=case)
    before = bt.block_topk_candidates.launches
    got = bt.block_topk_candidates(tiles, m)
    assert bt.block_topk_candidates.launches == before + 1
    want = bt.block_topk_candidates_ref(tiles, m)
    torch.cuda.synchronize()
    for g, w in zip(got, want, strict=True):
        _equal(g, w)
    if case == "nan":
        assert (got[1][1, 1] == bt.INT32_MAX).all()


@pytest.mark.cuda
@pytest.mark.parametrize("m", SELECT_M)
def test_fused_kernel_with_ties_after_the_shared_header(card, m):
    """Kernel 1 on the shared selection rounds: equal scores (a rounded
    to quarters with nothing sent, so the score is |a|) still come out
    lowest index first, bit for bit."""
    xs = _tiles("cuda")
    xs[0] = torch.round(4.0 * xs[0]) / 4.0
    xs[2] = torch.zeros_like(xs[2])
    kw = dict(KW, m=m)
    got = fe.fused_candidates(*xs, y=1.0, **kw)
    want = fe.fused_candidates_ref(*xs, y=1.0, **kw)
    torch.cuda.synchronize()
    for g, w in zip(got, want, strict=True):
        _equal(g, w)



def _adversarial(case, W=2, n=3 * 8192, seed=21):
    """``[W, n]`` numpy scores that stress the radix select: "equal" (one
    value), "four" (four values, so the ties straddle the m-th key across
    threads), "zeros" (-0.0 and +0.0 mixed, a few positives), "-inf" (runs
    of -inf with a few finite scores), "subnormal" (subnormals of both
    signs) and "+inf" (+inf among |N(0, 1)|)."""
    rng = np.random.default_rng(seed)
    if case == "equal":
        s = np.full((W, n), 1.5)
    elif case == "four":
        s = rng.choice([0.5, 1.0, 2.0, 3.0], (W, n))
    elif case == "zeros":
        s = np.where(rng.random((W, n)) < 0.5, -0.0, 0.0)
        s[rng.random((W, n)) < 0.002] = 1.0
    elif case == "-inf":
        s = np.abs(rng.standard_normal((W, n)))
        s[:, 8192:16384] = -np.inf
        s[:, 2000:2500] = -np.inf
        s[:, [8192 + 9, 8192 + 700, 16383]] = [2.0, 5.0, 2.0]
    elif case == "subnormal":
        s = rng.integers(1, 64, (W, n)) * np.float32(1e-45)
        s = np.where(rng.random((W, n)) < 0.3, -s, s)
    else:
        s = np.abs(rng.standard_normal((W, n)))
        s[rng.random((W, n)) < 0.01] = np.inf
    return s.astype(np.float32)


def _bits_equal(got, want):
    """f32 (or int32) outputs equal bit for bit, NaN payloads included."""
    for g, w in zip(got, want, strict=True):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("m", SELECT_M)
@pytest.mark.parametrize("case", ["equal", "four", "zeros", "-inf", "subnormal", "+inf"])
def test_block_topk_radix_select_bit_for_bit(card, case, m):
    tiles = ops._tile(torch.tensor(_adversarial(case), device="cuda"))[0]
    before = bt.block_topk_candidates.launches
    got = bt.block_topk_candidates(tiles, m)
    assert bt.block_topk_candidates.launches == before + 1
    want = bt.block_topk_candidates_ref(tiles, m)
    torch.cuda.synchronize()
    _bits_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("m", SELECT_M)
@pytest.mark.parametrize("case", ["equal", "four", "zeros", "subnormal", "+inf"])
def test_fused_radix_select_bit_for_bit(card, case, m):
    """Kernel 1 on the same tiles: with nothing sent and q = 1e9 the score
    is |a| exactly, and the gradient takes random signs, so -0.0 a-values
    come out as +0.0 (scores are never -0.0 or -inf)."""
    a = _adversarial(case)
    a = np.where(np.random.default_rng(3).random(a.shape) < 0.5, -a, a)
    zeros = np.zeros_like(a)
    xs = [ops._tile(torch.tensor(x, device="cuda"))[0] for x in (a, zeros, zeros, zeros)]
    kw = dict(KW, m=m)
    before = fe.fused_candidates.launches
    got = fe.fused_candidates(*xs, y=1.0, **kw)
    assert fe.fused_candidates.launches == before + 1
    want = fe.fused_candidates_ref(*xs, y=1.0, **kw)
    torch.cuda.synchronize()
    _bits_equal(got, want)
    if case == "zeros":
        assert not bool((got[1].view(torch.int32) == -2**31).any())


@pytest.mark.cuda
@pytest.mark.parametrize("m", [16, 257])
def test_selection_kernels_on_unaligned_tiles(card, m):
    """Tiles 4 bytes past a 16-byte boundary take the kernels' scalar
    loads instead of float4, with the same bits."""
    tiles = _unaligned(_score_tiles(case="ties"))
    assert tiles.data_ptr() % 16 == 4
    _bits_equal(bt.block_topk_candidates(tiles, m),
                bt.block_topk_candidates_ref(tiles, m))
    xs = [_unaligned(x) for x in _tiles("cuda")]
    kw = dict(KW, m=m)
    _bits_equal(fe.fused_candidates(*xs, y=1.0, **kw),
                fe.fused_candidates_ref(*xs, y=1.0, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["coo_fp32", "coo_idx_delta", "bitmap_dense", "coo_q8"])
@pytest.mark.parametrize("L", [127, 32768, 4_458_752])
def test_codecs_on_the_card_equal_the_cpu_bits(card, name, L):
    """Every codec's payload, decode and ``decoded_dense`` on the card
    equal the CPU's in bits, padding slots (index 0, -0.0) included: the
    CUDA scatter-add may reorder the additions at index 0, and they add
    only zeros there."""
    from repro_torch.comm.codec import get_codec

    rng = np.random.default_rng(L)
    W, k = 8, max(8, L // 100)
    vals = rng.standard_normal((W, k)).astype(np.float32)
    idx = np.stack([rng.choice(L, k, replace=False) for _ in range(W)])
    vals[:, -3:], idx[:, -3:] = -0.0, 0
    codec = get_codec(name)
    out = {}
    for dev in ("cpu", "cuda"):
        v = torch.tensor(vals, device=dev)
        i = torch.tensor(idx, dtype=torch.int64, device=dev)
        pay = codec.encode(v, i, L)
        out[dev] = (pay, codec.decode(pay, L), codec.decoded_dense(pay, L))
    for key in out["cpu"][0]:
        a, b = out["cpu"][0][key], out["cuda"][0][key].cpu()
        assert torch.equal(a.view(torch.int32) if a.dtype == torch.float32 else a,
                           b.view(torch.int32) if b.dtype == torch.float32 else b), key
    for a, b in zip(out["cpu"][1] + (out["cpu"][2],),
                    out["cuda"][1] + (out["cuda"][2],), strict=True):
        b = b.cpu()
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_coordinate_weighting_on_the_card_equals_the_cpu(card):
    """The simulator under coordinate weighting: ``"auto"`` declines the
    score kernel on the card, and the run equals the CPU run's masks."""
    rng = np.random.default_rng(1)
    X = rng.standard_normal((4, 50, 300)).astype(np.float32)
    yv = rng.standard_normal((4, 50)).astype(np.float32)
    out = {}
    for dev in ("cpu", "cuda"):
        Xd, yd = torch.tensor(X, device=dev), torch.tensor(yv, device=dev)

        def grad_fn(theta, widx, Xd=Xd, yd=yd):
            r = torch.einsum("ndj,j->nd", Xd[widx], theta) - yd[widx]
            return torch.einsum("ndj,nd->nj", Xd[widx], r) / 25.0

        sim = DistributedSim(grad_fn, 4, 300,
                             SparsifierConfig(kind="regtopk", sparsity=0.1, mu=4.0),
                             aggregation="sparse_allgather", fastpath="auto",
                             weighting="coordinate", device=dev)
        assert sim.sparsifier.cfg.score_fn is None
        before = rs.regtopk_score.launches
        out[dev] = sim.run(torch.zeros(300), 5,
                           trace_state_fn=lambda s: s.worker_states.s_prev)
        assert rs.regtopk_score.launches == before
    assert torch.equal(out["cpu"][1], out["cuda"][1].cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("collective", ["sparse_allgather", "dense_allreduce"])
def test_nccl_world_one_round_equals_the_one_card_round(card, tmp_path,
                                                         collective):
    """Two rounds of the per-rank round over ``nccl`` at world size 1
    (the kernel 1 fastpath on a 3-tile leaf) against the one-card round of
    one worker: the aggregate and every state field in bits."""
    import torch.distributed as dist

    from repro_torch.comm.fastpath import FastpathCounts
    from repro_torch.core import distributed as td
    from repro_torch.launch import mesh

    shapes = {"big": (3 * 8192 + 17,), "small": (4, 33)}
    dcfg = td.DistConfig(
        sparsifier=SparsifierConfig(kind="regtopk", sparsity=0.005, mu=1.0),
        collective=collective, fastpath="on")
    plan = td.build_plan({n: torch.zeros(s, device="cuda")
                          for n, s in shapes.items()}, 0.005, dcfg)
    rng = np.random.default_rng(3)
    grads = [{n: torch.tensor(rng.standard_normal((1, *s)), dtype=torch.float32,
                              device="cuda") for n, s in shapes.items()}
             for _ in range(2)]
    mesh.init_file_store(str(tmp_path / "store"), 0, 1, "nccl")
    try:
        out = {}
        for form, groups in (("one card", None), ("ranks", mesh.make_host_groups())):
            counts = FastpathCounts()
            spa = td.make_sparsify_aggregate(plan, dcfg, 1, counts, groups)
            state = td.init_sparsifier_state(plan, 1, "cuda")
            rounds = []
            for g in grads:
                agg, state = spa(g, state)
                rounds.append((agg, state))
            out[form] = (rounds, counts.rounds)
    finally:
        dist.destroy_process_group()
    assert out["ranks"][1] == out["one card"][1]
    for (agg, st), (agg1, st1) in zip(out["ranks"][0], out["one card"][0],
                                      strict=True):
        for n in shapes:
            for a, b in [(agg[n], agg1[n]), *zip(st[n], st1[n], strict=True)]:
                a, b = a.cpu(), b.cpu()
                if a.dtype == torch.float32:
                    a, b = a.view(torch.int32), b.view(torch.int32)
                assert torch.equal(a, b)
