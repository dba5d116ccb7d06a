"""Smoke run of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each raising on failure (the script then exits non-zero):

1. device   — the card's name, and its name and power limit from nvidia-smi;
2. build    — every CUDA source of the port compiled with nvcc (sm_90a);
3. kernels  — the fused select→encode kernel against its plain PyTorch
              version at every leaf shape of paper-resnet-proxy at full
              width with W = 8 workers, plus a ragged length, y = 2, a
              certificate failure, and a tile with one NaN score and one
              of NaN scores only; timed beside its plain version, the
              library top-k of a precomputed dense score, and its bound;
              then bit for bit on adversarial tiles (one value, four
              values, signed zeros, subnormals, +inf) at every budget m
              from 1 to 8192;
4. score    — the RegTop-k score kernel against its plain PyTorch version,
              bit for bit, at every leaf shape of paper-resnet-proxy with
              W = 8, the model's flat length (the simulator at full width),
              Fig. 3's N = 20 x J = 100, a ragged length, y = 2 and 1.5,
              zero denominators, an all-unsent state and a NaN input; each
              timed beside its plain version and its bound;
5. select   — the sort-free selection kernels (count_above, global_max,
              block_topk_candidates) against their plain versions, bit for
              bit, at kernel_bench's shape (N = 262,144, k = 262, m = 16),
              the full-width row (the RegTop-k score of paper-resnet-proxy's
              flat J = 4,458,752 vector, k = 4,459 and 44,588, m = 16), a
              ragged length, an all-zero score, k >= L and a NaN input,
              and ``block_topk_candidates`` bit for bit on the adversarial
              tiles (those of the kernels phase and runs of -inf) at every
              budget m from 1 to 8192; the
              main path (``ops.threshold_topk_mask`` at both k and
              ``ops.hierarchical_topk`` on the full-width row, no host sync
              in the bisection) with its launches counted; the kernel-driven
              mask held bit for bit against ``core.selectors``' plain
              bisection; the hierarchical top-k's recall; each kernel, both
              whole selections, their plain versions and the library calls
              timed, with the bounds from bytes;
6. trainer  — the port's trainer (``repro_torch.launch.train``) on
              paper-resnet-proxy at full width, W = 8, RegTop-k at S = 0.01,
              fastpath on, for 10 steps: finite losses, one kernel launch
              per fused leaf per step, the certificate hit rate, one step
              held against the fastpath off, and a small run held against
              the same run on the CPU; then 10 steps each of cyclic, of
              dense_allreduce and of the threshold selector (set through
              ``DistConfig``), each with finite losses and its comm line;
7. sim      — the port's simulator (``repro_torch.core.DistributedSim``):
              the paper's Fig. 1 toy with its assertions; Fig. 3 at its
              published size (N = 20, J = 100, 2500 rounds), RegTop-k with
              the fastpath on and off equal bit for bit and one score kernel
              launch per round; and whole-model selection at full width
              (N = 8, J = 4,458,752, RegTop-k at S = 0.01, 5 rounds), fastpath
              on against off round by round, with the round times and the
              device's busy share;
8. wire     — the wire at full width: the trainer (W = 8, RegTop-k at
              S = 0.01) with coo_idx_delta and coo_q8 through the fused
              kernel (launches counted, one step's encoded payloads on ==
              off bit for bit, measured bytes <= 1.05 x predicted),
              bitmap_dense (which never fuses: no launch), coordinate
              weighting (sent_w recorded), fastpath auto under the table
              ThroughputTable.measure() fits on this card (payloads ==
              off), and a smoke run per codec against the same run on the
              CPU; the simulator (N = 8, J = 4,458,752, 5 rounds each)
              with coo_q8 on == off in theta and eps, coordinate weighting
              (auto == off, no score launch), hierarchical == sparse_allgather
              with coo_idx_delta, and wire_bytes_per_round per codec; the
              step and round time of each path.

Each kernel's launch count is set to 0 just before the path that runs it
(select: ``count_above``, ``global_max``, ``block_topk_candidates``;
trainer and each fused wire run: ``fused_candidates``; sim and the wire
simulator's fastpath-on run: ``regtopk_score``) and read just after; the
``kernels`` line sums each kernel's main-path launches. The line before the last is the card's nvidia-smi line; before it,
the ``kernels`` JSON line. The last line is the device JSON.
``--details FILE`` also writes every phase's results to FILE as JSON.
``--parent DIR`` (a checkout of the parent commit) adds, last, the time of
kernel 1 per training step and of ``block_topk_candidates`` at full width
for both trees, measured in turns (parent, change, change, parent) in
fresh processes on this card, into the details.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
SCORE_OPS = 12  # f32 operations of the score chain per element, tanh as one
SCORE_BYTES = 20  # the score pass: four f32 reads and one f32 write
DEVICE = "cuda"
W = 8
STEPS = 10
TRAIN_ARGS = [
    "--arch", "paper-resnet-proxy", "--workers", str(W),
    "--sparsifier", "regtopk", "--sparsity", "0.01", "--fastpath", "on",
    "--global-batch", "32", "--seq", "128", "--log-every", "1",
]


def log(msg: str) -> None:
    print(msg, flush=True)


def median_ms(fn, iters: int = 20, warmup: int = 3, inner: int = 5) -> float:
    """Device milliseconds of one call of ``fn``: the median of ``iters``
    samples after warm-up, each the mean of ``inner`` back-to-back calls.
    A sleep kernel holds the stream while the host queues the calls, so
    the CUDA events bracket the device's work and not the host's launch
    overhead (which would dominate a small leaf)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)  # ~10 ms at the H100's clock
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def phase_device() -> tuple[str, str]:
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"device: {name} (torch {torch.__version__}, CUDA {torch.version.cuda})")
    log(f"nvidia-smi: {smi}")
    return name, smi


def phase_build() -> dict:
    from repro_torch.kernels import build

    built = build.build_all()
    for name, (lib, seconds, report) in built.items():
        log(f"build: {name} -> {lib.name} in {seconds:.1f} s")
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                log(f"build:   {line.strip()}")
    return {n: round(s, 3) for n, (_, s, _) in built.items()}


def _leaf_inputs(L: int, k: int, gen: torch.Generator, poison=None,
                 workers: int = W):
    """[workers, L] gradient accumulator and the dense scatter of a random
    previous payload: what fused_compact_select hands the kernel.
    ``poison`` makes the certificate fail: "concentrate" puts the mass in
    one tile, "nan" puts one NaN in tile 1, "nan tile" fills tile 1."""
    a = 1e-3 * torch.randn((workers, L), generator=gen)
    if poison == "concentrate":
        a[:, : min(L, 4096)] *= 1e3
    elif poison == "nan":
        a[:, 8192 + 5] = float("nan")
    elif poison == "nan tile":
        a[:, 8192:16384] = float("nan")
    sent = torch.stack(
        [torch.randperm(L, generator=gen)[:k] for _ in range(workers)]
    )
    ones = torch.ones((workers, k))
    z = torch.zeros((workers, L))
    s_prev = z.scatter(1, sent, ones)
    a_prev = z.scatter(1, sent, 1e-3 * torch.randn((workers, k), generator=gen))
    g_prev = z.scatter(1, sent, 1e-4 * torch.randn((workers, k), generator=gen))
    return [x.cuda() for x in (a, a_prev, s_prev, g_prev)]


def _abs_diff(x: torch.Tensor, y: torch.Tensor) -> float:
    """Largest |x - y|; NaN on both sides agrees, NaN on one side gives
    NaN."""
    both = torch.isnan(x) & torch.isnan(y)
    return float(torch.where(both, 0.0, x - y).abs().max())


def _model_leaves() -> dict:
    """{leaf path: element count} of paper-resnet-proxy at full width."""
    from repro_torch import configs
    from repro_torch.models import lm
    from repro_torch.tree import tree_items

    cfg = configs.get_config("paper-resnet-proxy")
    return {
        path: leaf.numel()
        for path, leaf in tree_items(lm.init(cfg, device="meta"))
    }


def _bit_mismatches(x: torch.Tensor, y: torch.Tensor) -> int:
    """Elements whose f32 bits differ, NaN against NaN counting as equal;
    a NaN on one side only is a mismatch."""
    both = torch.isnan(x) & torch.isnan(y)
    return int(((x.view(torch.int32) != y.view(torch.int32)) & ~both).sum())


ADVERSARIAL = ("equal", "four", "zeros", "-inf", "subnormal", "+inf")
ADVERSARIAL_M = (1, 8, 16, 36, 128, 257, 512, 8192)


def _adversarial(case: str, gen: torch.Generator, workers: int = W,
                 n: int = 3 * 8192) -> torch.Tensor:
    """``[workers, n]`` scores on the CPU that stress the per-tile radix
    select: "equal" (one value), "four" (four values, so the ties straddle
    the m-th key across threads), "zeros" (-0.0 and +0.0 mixed, a few
    positives), "-inf" (runs of -inf, a few finite scores in tile 1),
    "subnormal" (subnormals of both signs, made from their bits) and
    "+inf" (+inf among |N(0, 1)|)."""
    shape = (workers, n)
    u = torch.rand(shape, generator=gen)
    if case == "equal":
        return torch.full(shape, 1.5)
    if case == "four":
        return torch.tensor([0.5, 1.0, 2.0, 3.0])[
            torch.randint(0, 4, shape, generator=gen)]
    if case == "zeros":
        s = torch.where(u < 0.5, torch.tensor(-0.0), torch.tensor(0.0))
        return torch.where(torch.rand(shape, generator=gen) < 0.002, 1.0, s)
    if case == "subnormal":
        s = torch.randint(1, 64, shape, generator=gen, dtype=torch.int32)
        return torch.where(u < 0.3, s | -2**31, s).view(torch.float32)
    s = torch.randn(shape, generator=gen).abs()
    if case == "-inf":
        s[:, 8192:16384] = -math.inf
        s[:, 2000:2500] = -math.inf
        s[:, [8192 + 9, 8192 + 700, 16383]] = torch.tensor([2.0, 5.0, 2.0])
        return s
    return torch.where(u < 0.01, math.inf, s)


def kernel1_adversarial(gen: torch.Generator) -> dict:
    """Kernel 1 against its plain version, bit for bit, on the adversarial
    tiles at every budget: nothing sent and q = 1e9, so the score is |a|
    exactly; the gradient takes random signs, so -0.0 a-values must come
    out as +0.0 (scores are never negative, so no "-inf" tile)."""
    from repro_torch.kernels import fused_encode as fe
    from repro_torch.kernels import ops

    checked = 0
    for case in ADVERSARIAL:
        if case == "-inf":
            continue
        a = _adversarial(case, gen)
        a = torch.where(torch.rand(a.shape, generator=gen) < 0.5, -a, a)
        z = torch.zeros_like(a)
        tiles = [ops._tile(x.to(DEVICE))[0] for x in (a, z, z, z)]
        for m in ADVERSARIAL_M:
            kw = dict(omega=1.0 / W, mu=1.0, q=1e9, y=1.0, m=m)
            got = fe.fused_candidates(*tiles, **kw)
            want = fe.fused_candidates_ref(*tiles, **kw)
            torch.cuda.synchronize()
            bad = sum(_bit_mismatches(g, w) for g, w in zip(got, want, strict=True))
            if bad:
                raise AssertionError(f"kernel 1 on {case} tiles, m = {m}: {bad} "
                                     "outputs differ in bits from the plain version")
            checked += 1
    log(f"kernel: adversarial tiles ({', '.join(c for c in ADVERSARIAL if c != '-inf')})"
        f" at m = {list(ADVERSARIAL_M)}: bit-equal to the plain version")
    return {"cases": [c for c in ADVERSARIAL if c != "-inf"],
            "m": list(ADVERSARIAL_M), "checked": checked}


def phase_kernels() -> dict:
    """Kernel against plain version at the main path's shapes."""
    from repro_torch.comm import fastpath as fp
    from repro_torch.core.selectors import sparsity_to_k, topk_stable
    from repro_torch.kernels import fused_encode as fe
    from repro_torch.kernels import ops
    from repro_torch.kernels import regtopk_score as rs

    leaves = _model_leaves()
    mlp = leaves["layers.mlp.wg"]
    # (name, length, y, poison, on the trainer's path)
    cases = [(path, n, 1.0, None, True) for path, n in leaves.items()] + [
        ("ragged", 3 * 8192 + 17, 1.0, None, False),
        ("layers.mlp.wg y=2", mlp, 2.0, None, False),
        ("certificate failure", mlp, 1.0, "concentrate", False),
        ("one NaN in a tile", mlp, 1.0, "nan", False),
        ("all-NaN tile", mlp, 1.0, "nan tile", False),
    ]
    gen = torch.Generator().manual_seed(0)
    rows, max_err = [], 0.0
    totals = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0}
    for name, L, y, poison, main_path in cases:
        k = sparsity_to_k(L, 0.01)
        m = fp.candidate_budget(L, k)
        xs = _leaf_inputs(L, k, gen, poison)
        tiles = [ops._tile(x)[0] for x in xs]
        kw = dict(omega=1.0 / W, mu=1.0, q=1e9, y=y, m=m)
        cs, cv, ci = fe.fused_candidates(*tiles, **kw)
        ref_s, ref_v, ref_i = fe.fused_candidates_ref(*tiles, **kw)
        torch.cuda.synchronize()
        if not torch.equal(ci, ref_i):
            bad = int((ci != ref_i).sum())
            raise AssertionError(f"{name}: {bad} candidate indices differ")
        err = max(_abs_diff(cs, ref_s), _abs_diff(cv, ref_v))
        bad = _bit_mismatches(cs, ref_s) + _bit_mismatches(cv, ref_v)
        if err != 0.0 or bad:
            raise AssertionError(
                f"{name}: {bad} candidate scores/values differ from the plain "
                f"version in bits (max |diff| {err:g}); the score chain must "
                "be bit-equal"
            )
        max_err = max(max_err, err)
        vals, idx, ok = fe.select_from_candidates(cs, cv, ci, k)
        score = rs.score_chain(*xs, omega=1.0 / W, mu=1.0, q=1e9, y=y)
        _, didx = topk_stable(score, k)
        dvals = torch.gather(xs[0], 1, didx) * (torch.gather(score, 1, didx) > 0)
        for w in torch.nonzero(ok)[:, 0].tolist():
            if not (torch.equal(idx[w], didx[w]) and torch.equal(vals[w], dvals[w])):
                raise AssertionError(f"{name}: certified payload of worker {w} "
                                     "differs from the dense stable top-k")
        if poison and bool(ok.any()):
            raise AssertionError(f"{name}: the certificate should fail")
        ms = median_ms(lambda t=tiles, kw=kw: fe.fused_candidates(*t, **kw))
        plain_ms = median_ms(
            lambda t=tiles, kw=kw: fe.fused_candidates_ref(*t, **kw)
        )
        library_ms = median_ms(lambda s=score, k=k: torch.topk(s, k, dim=1))
        n_el = W * fp._n_tiles(L) * fp._TILE
        bound_ms = 1e3 * max(
            W * fp.fused_hbm_bytes(L, k, m) / HBM_BYTES_PER_S,
            SCORE_OPS * n_el / F32_OPS_PER_S,
        )
        row = dict(leaf=name, length=L, workers=W, k=k, m=m, y=y,
                   certified=int(ok.sum()), ms=ms, plain_ms=plain_ms,
                   library_ms=library_ms, bound_ms=bound_ms)
        rows.append(row)
        log("kernel: " + json.dumps(row))
        if main_path:
            for key in totals:
                totals[key] += row[key]
    adversarial = kernel1_adversarial(gen)
    return {"rows": rows, "max_abs_err": max_err, "per_step": totals,
            "adversarial": adversarial}


BENCH_N, BENCH_K = 262_144, 262  # benchmarks/kernel_bench.py's shape
SELECT_M = 16
FULL_K = (4_459, 44_588)  # S = 0.001 and 0.01 of the full-width row


def _host_ms(fn, iters: int = 10) -> float:
    """Host-clock milliseconds of one call of ``fn`` that ends in a
    synchronise: the latency a caller sees, launch overhead included."""
    fn()
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def _select_scores(gen: torch.Generator) -> list:
    """(name, score [L] on the card, thresholds' k, hierarchical k, main
    path) for the select phase."""
    from repro_torch.kernels import regtopk_score as rs

    def abs_normal(n):
        return (3.0 * torch.randn(n, generator=gen)).abs().to(DEVICE)

    J = sum(_model_leaves().values())
    xs = _leaf_inputs(J, FULL_K[1], gen, workers=1)
    wide = rs.score_chain(*xs, omega=1.0 / W, mu=1.0, q=1e9, y=1.0)[0]
    ragged = 3 * 8192 + 17
    nan = abs_normal(BENCH_N)
    nan[BENCH_N // 3] = float("nan")
    return [
        ("kernel_bench", abs_normal(BENCH_N), [BENCH_K], BENCH_K, False),
        ("full width", wide, list(FULL_K), FULL_K[0], True),
        ("ragged", abs_normal(ragged), [25], 25, False),
        ("all-zero", torch.zeros(BENCH_N, device=DEVICE), [BENCH_K], BENCH_K, False),
        ("k >= L", abs_normal(ragged), [ragged], 4 * SELECT_M, False),
        ("NaN input", nan, [BENCH_K], BENCH_K, False),
    ]


def _select_times(score, st, k_list, k_hier) -> dict:
    """Device times of each kernel per launch, the whole selections, their
    plain versions and the library calls, with the bounds from bytes, for
    one score."""
    from repro_torch.core import selectors
    from repro_torch.core.selectors import topk_stable
    from repro_torch.kernels import block_topk as bt
    from repro_torch.kernels import ops
    from repro_torch.kernels import threshold_topk as tt

    P = st.numel()
    nblk = P // 8192
    tau = 0.5 * tt.global_max(st)

    def hier_plain():
        v, i = bt.block_topk_candidates_ref(st, SELECT_M)
        top, pos = topk_stable(v.reshape(1, -1), k_hier)
        return top, torch.gather(i.reshape(1, -1), 1, pos)

    out = {"padded": P, "kernels": {
        "count_above": dict(
            ms=median_ms(lambda: tt.count_above(st, tau)),
            plain_ms=median_ms(lambda: tt.count_above_ref(st, tau)),
            library_ms=None, bound_ms=1e3 * (4 * P + 4) / HBM_BYTES_PER_S),
        "global_max": dict(
            ms=median_ms(lambda: tt.global_max(st)),
            plain_ms=median_ms(lambda: tt.global_max_ref(st)),
            library_ms=median_ms(lambda: torch.amax(score)),
            bound_ms=1e3 * (4 * P + 4) / HBM_BYTES_PER_S),
        "block_topk_candidates": dict(
            ms=median_ms(lambda: bt.block_topk_candidates(st, SELECT_M)),
            plain_ms=median_ms(lambda: bt.block_topk_candidates_ref(st, SELECT_M)),
            library_ms=median_ms(lambda: torch.topk(st.view(-1, 8192), SELECT_M)),
            bound_ms=1e3 * (4 * P + 8 * nblk * SELECT_M) / HBM_BYTES_PER_S),
    }, "selections": {}}
    sel = out["selections"]
    for k in k_list:
        sel[f"threshold k={k}"] = dict(
            ms=median_ms(lambda k=k: ops.threshold_topk_mask(score, k), inner=1),
            host_ms=_host_ms(lambda k=k: ops.threshold_topk_mask(score, k)),
            plain_ms=median_ms(
                lambda k=k: selectors.threshold_topk_mask(score, k), inner=1),
            plain_host_ms=_host_ms(
                lambda k=k: selectors.threshold_topk_mask(score, k)),
            library_ms=median_ms(lambda k=k: torch.topk(score, k)),
            # one max pass, 24 count passes, the mask's read and write
            passes_bound_ms=1e3 * 27 * 4 * P / HBM_BYTES_PER_S,
            # the score read once, the mask written once
            bound_ms=1e3 * 8 * score.numel() / HBM_BYTES_PER_S)
    sel[f"hierarchical k={k_hier}"] = dict(
        ms=median_ms(lambda: ops.hierarchical_topk(score, k_hier, SELECT_M)),
        host_ms=_host_ms(lambda: ops.hierarchical_topk(score, k_hier, SELECT_M)),
        plain_ms=median_ms(hier_plain),
        library_ms=median_ms(lambda: torch.topk(score, k_hier)),
        bound_ms=1e3 * (4 * score.numel() + 8 * k_hier) / HBM_BYTES_PER_S)
    for name, row in {**out["kernels"], **sel}.items():
        log(f"select time {name}: " + json.dumps(row))
    return out


def phase_select() -> dict:
    """The sort-free selection kernels on the card: the main path counted,
    every kernel held bit for bit against its plain version, the
    kernel-driven mask against the plain selector, recall and times."""
    from repro_torch.core import selectors
    from repro_torch.core.selectors import topk_stable
    from repro_torch.kernels import block_topk as bt
    from repro_torch.kernels import ops
    from repro_torch.kernels import threshold_topk as tt

    gen = torch.Generator().manual_seed(2)
    cases = _select_scores(gen)
    wide = next(c for c in cases if c[4])[1]
    kernels = (tt.count_above, tt.global_max, bt.block_topk_candidates)

    # the main path: both threshold selections and the hierarchical top-k
    # of the full-width row; the bisection may not sync with the host
    for fn in kernels:
        fn.launches = 0
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        masks = {k: ops.threshold_topk_mask(wide, k) for k in FULL_K}
    finally:
        torch.cuda.set_sync_debug_mode("default")
    hier = ops.hierarchical_topk(wide, FULL_K[0], SELECT_M)
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in kernels}
    expected = {"count_above": 24 * len(FULL_K), "global_max": len(FULL_K),
                "block_topk_candidates": 1}
    if launches != expected:
        raise AssertionError(f"select: launches {launches}, expected {expected}")
    log(f"select: main path launches {json.dumps(launches)}")

    # the kernel-driven mask is the plain selector's, bit for bit (k < L)
    for k, mask in masks.items():
        want = selectors.threshold_topk_mask(wide, k)
        if not torch.equal(mask, want):
            raise AssertionError(
                f"select: ops.threshold_topk_mask (k={k}) differs from "
                f"core.selectors' in {int((mask != want).sum())} places")
        if int(mask.sum()) < k:
            raise AssertionError(f"select: the k={k} mask holds {int(mask.sum())}")
    log("select: full width, ops.threshold_topk_mask == core.selectors."
        "threshold_topk_mask bit for bit at k = " + ", ".join(map(str, FULL_K))
        + f" (mask sizes {[int(m.sum()) for m in masks.values()]})")

    errs = {fn.__name__: 0.0 for fn in kernels}
    rows = []
    for name, score, k_list, k_hier, _ in cases:
        st, _ = ops._tile(score.reshape(1, -1))
        gm, gm_ref = tt.global_max(st), tt.global_max_ref(st)
        tau = 0.5 * gm_ref
        c, c_ref = tt.count_above(st, tau), tt.count_above_ref(st, tau)
        cand = bt.block_topk_candidates(st, SELECT_M)
        cand_ref = bt.block_topk_candidates_ref(st, SELECT_M)
        mask_bad = 0
        for k in k_list:
            mask = tt.threshold_topk_mask(st, k)
            mask_bad += _bit_mismatches(mask, tt.threshold_topk_mask_ref(st, k))
        torch.cuda.synchronize()
        err = {
            "global_max": _abs_diff(gm, gm_ref),
            "count_above": float((c - c_ref).abs().max()),
            "block_topk_candidates": _abs_diff(cand[0], cand_ref[0]),
        }
        if (any(v != 0.0 for v in err.values()) or mask_bad
                or _bit_mismatches(cand[0], cand_ref[0])
                or not torch.equal(cand[1], cand_ref[1])):
            raise AssertionError(
                f"select {name}: kernels differ from their plain versions "
                f"({err}, {mask_bad} mask elements, candidate indices equal: "
                f"{torch.equal(cand[1], cand_ref[1])})")
        for key, v in err.items():
            errs[key] = max(errs[key], v)
        top_v, top_i = ops.hierarchical_topk(score, k_hier, SELECT_M)
        _, true_i = topk_stable(score.float(), k_hier)
        found = torch.isin(top_i.long(), true_i).sum()
        recall = float(found) / k_hier
        if name == "NaN input":
            if not (bool(torch.isnan(gm).all()) and bool(torch.isnan(cand[0]).any())):
                raise AssertionError("select NaN input: the NaN did not propagate")
        elif not bool(torch.isfinite(top_v).all()):
            raise AssertionError(f"select {name}: non-finite top-k values")
        row = dict(case=name, length=score.numel(), padded=st.numel(), k=k_list,
                   k_hier=k_hier, m=SELECT_M, recall=recall,
                   mask_sizes=[int(tt.threshold_topk_mask(st, k).sum())
                               for k in k_list])
        rows.append(row)
        log("select: " + json.dumps(row) + " (kernels bit-equal to plain)")

    adversarial = block_adversarial(gen)
    times = {"full width": _select_times(wide, ops._tile(wide.reshape(1, -1))[0],
                                         list(FULL_K), FULL_K[0]),
             "kernel_bench": _select_times(cases[0][1],
                                           ops._tile(cases[0][1].reshape(1, -1))[0],
                                           [BENCH_K], BENCH_K)}
    # where a whole selection's time goes: one call under the profiler,
    # against its host-clock latency
    sel = times["full width"]["selections"]
    k = FULL_K[0]
    profile = {
        "threshold": profile_step(lambda: ops.threshold_topk_mask(wide, k),
                                  sel[f"threshold k={k}"]["host_ms"]),
        "hierarchical": profile_step(
            lambda: ops.hierarchical_topk(wide, k, SELECT_M),
            sel[f"hierarchical k={k}"]["host_ms"]),
    }
    return {"launches": launches, "max_abs_err": errs, "rows": rows,
            "adversarial": adversarial, "times": times, "profile": profile,
            "recall_full_width": float(torch.isin(
                hier[1].long(), topk_stable(wide, FULL_K[0])[1]).sum()) / FULL_K[0]}


def block_adversarial(gen: torch.Generator) -> dict:
    """``block_topk_candidates`` against its plain version, bit for bit, on
    every adversarial tile at every budget."""
    from repro_torch.kernels import block_topk as bt
    from repro_torch.kernels import ops

    checked = 0
    for case in ADVERSARIAL:
        st = ops._tile(_adversarial(case, gen).to(DEVICE))[0]
        for m in ADVERSARIAL_M:
            got = bt.block_topk_candidates(st, m)
            want = bt.block_topk_candidates_ref(st, m)
            torch.cuda.synchronize()
            bad = sum(_bit_mismatches(g, w) for g, w in zip(got, want, strict=True))
            if bad:
                raise AssertionError(f"select: block_topk_candidates on {case} "
                                     f"tiles, m = {m}: {bad} outputs differ in bits")
            checked += 1
    log(f"select: block_topk_candidates on adversarial tiles ({', '.join(ADVERSARIAL)})"
        f" at m = {list(ADVERSARIAL_M)}: bit-equal to the plain version")
    return {"cases": list(ADVERSARIAL), "m": list(ADVERSARIAL_M), "checked": checked}


def phase_trainer() -> dict:
    from repro_torch.core import distributed as td
    from repro_torch.core.sparsify import SparsifierConfig
    from repro_torch.data import TokenPipeline
    from repro_torch.kernels import fused_encode as fe
    from repro_torch.launch import train
    from repro_torch.optim import OptConfig, make_optimizer
    from repro_torch.tree import tree_items, tree_leaves

    args = train.parse_args([*TRAIN_ARGS, "--steps", str(STEPS)])
    fe.fused_candidates.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = train.run(args)
    losses, params, sp_state, counts = res.losses, res.params, res.sp_state, res.counts
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = fe.fused_candidates.launches
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    n_fused = sum(p.fused for p in tree_leaves(res.plan))
    if launches != STEPS * n_fused or launches == 0:
        raise AssertionError(
            f"{launches} kernel launches, expected {STEPS} steps x "
            f"{n_fused} fused leaves"
        )
    log(f"trainer: {STEPS} steps in {seconds:.2f} s, losses {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}, {launches} kernel launches, certificate hit rate "
        f"{counts.hit_rate:.4f} ({counts.rounds - counts.fallbacks}/"
        f"{counts.rounds})")

    # one more step from the trained state, fastpath on vs off
    from repro_torch import configs

    cfg = configs.get_config(args.arch)
    batch = TokenPipeline(cfg, args.global_batch, args.seq, 1, "cuda").batch_at(0)
    runs, outs = {}, {}
    for mode in ("on", "off"):
        dist = td.DistConfig(
            sparsifier=SparsifierConfig(kind="regtopk", sparsity=args.sparsity),
            optimizer=OptConfig(learning_rate=args.lr), fastpath=mode,
        )
        plan = td.build_plan(params, args.sparsity, dist)
        step = td.make_train_step(cfg, dist, plan, W)
        opt_state = make_optimizer(dist.optimizer).init(params)
        runs[mode] = lambda step=step, o=opt_state: step(params, o, sp_state, batch)
        outs[mode] = runs[mode]()
    for (path, on), (_, off) in zip(
        tree_items(outs["on"][2]), tree_items(outs["off"][2]), strict=True
    ):
        if not torch.equal(on.sent_idx, off.sent_idx):
            raise AssertionError(f"{path}: fastpath on/off payloads differ")
        if not torch.equal(on.sent_vals, off.sent_vals):
            raise AssertionError(f"{path}: fastpath on/off values differ")
    log("trainer: one step from the trained state, fastpath on == off "
        "(payload indices and values bit-equal)")
    crowd = winners_per_tile(outs["off"][2], res.plan)
    step_ms, _ = turn_times(runs, "trainer: step time")
    profile = {m: profile_step(run, step_ms[m]) for m, run in runs.items()}

    # a small run against the same run on the CPU (plain kernel version);
    # float32 matmuls sum in another order there, hence 1e-4 relative
    small = ["--smoke", "--workers", "2", "--steps", "3", "--seq", "32",
             "--fastpath", "on", "--log-every", "100"]
    gpu = train.run(train.parse_args(small)).losses
    cpu = train.run(train.parse_args([*small, "--device", "cpu"])).losses
    for g, c in zip(gpu, cpu, strict=True):
        if abs(g - c) > 1e-4 * abs(c):
            raise AssertionError(f"card losses {gpu} vs CPU losses {cpu}")
    log(f"trainer: smoke run on the card matches the CPU run ({gpu} vs {cpu})")
    return {"losses": losses, "launches": launches, "seconds": seconds,
            "hit_rate": counts.hit_rate, "rounds": counts.rounds,
            "fallbacks": counts.fallbacks, "step_ms": step_ms,
            "profile": profile, "winners_per_tile": crowd,
            "kinds": trainer_kinds()}


def trainer_kinds() -> dict:
    """10 steps at full width, W = 8, of each selection the compact runtime
    adds in this slice: cyclic, the dense_allreduce collective, and the
    threshold selector (which the CLI has no flag for, as the JAX trainer
    has none: set through ``DistConfig``)."""
    from repro_torch.core import distributed as td
    from repro_torch.core.sparsify import SparsifierConfig
    from repro_torch.launch import train
    from repro_torch.optim import OptConfig

    base = [a for a in TRAIN_ARGS if a not in ("--fastpath", "on")]
    base += ["--fastpath", "off", "--steps", str(STEPS)]
    runs = {
        "cyclic": (["--sparsifier", "cyclic"], None),
        "dense_allreduce": (["--collective", "dense_allreduce"], None),
        "threshold": ([], lambda a: td.DistConfig(
            sparsifier=SparsifierConfig(kind=a.sparsifier, sparsity=a.sparsity,
                                        mu=a.mu, selector="threshold"),
            optimizer=OptConfig(learning_rate=a.lr))),
    }
    out = {}
    for name, (extra, make_dist) in runs.items():
        log(f"trainer {name}:")
        args = train.parse_args([*base, *extra])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = train.run(args, make_dist(args) if make_dist else None)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        if len(res.losses) != STEPS or not all(math.isfinite(x) for x in res.losses):
            raise AssertionError(f"trainer {name}: losses {res.losses}")
        log(f"trainer {name}: {STEPS} steps in {seconds:.2f} s, losses "
            f"{res.losses[0]:.4f} -> {res.losses[-1]:.4f}")
        out[name] = {"losses": res.losses, "seconds": seconds}
    return out


def winners_per_tile(sp_state, plan) -> dict:
    """For each leaf, the most top-k winners any one worker has in one
    8192-element tile, beside the candidate budget m that the certificate
    needs it to stay under."""
    from repro_torch.comm import fastpath as fp
    from repro_torch.tree import tree_items

    plans = dict(tree_items(plan))
    out = {}
    for path, st in tree_items(sp_state):
        p = plans[path]
        per_tile = torch.stack([
            torch.bincount(row // fp._TILE, minlength=fp._n_tiles(p.local_len))
            for row in st.sent_idx
        ])
        out[path] = {"max": int(per_tile.max()), "tiles": fp._n_tiles(p.local_len),
                     "m": fp.candidate_budget(p.local_len, p.k), "k": p.k}
    log("trainer: most top-k winners in one tile / budget m: " + ", ".join(
        f"{path} {v['max']}/{v['m']}" for path, v in out.items()))
    return out


def turn_times(runs: dict, label: str, reps: int = 5):
    """Host-clock milliseconds of one call of each run ("on", "off") from
    the same state, in turns (on, off, off, on), ``reps`` calls a turn.
    Returns (medians, samples)."""
    times = {mode: [] for mode in runs}
    for mode in ("on", "off", "off", "on"):
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runs[mode]()
            torch.cuda.synchronize()
            times[mode].append(1e3 * (time.perf_counter() - t0))
    out = {mode: statistics.median(ts) for mode, ts in times.items()}
    log(f"{label} {json.dumps(out)} ms (median of {2 * reps}, fastpath "
        "on/off in turns)")
    return out, times


def profile_step(run, step_ms: float) -> dict:
    """One training step under torch.profiler: the device time of its
    kernels, their share of the unprofiled step time ``step_ms``, and the
    heaviest kernels."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        run()
        torch.cuda.synchronize()
    rows = sorted(
        (
            (ev.self_device_time_total / 1e3, ev.count, ev.key)
            for ev in prof.key_averages()
            if ev.device_type == torch.autograd.DeviceType.CUDA
        ),
        reverse=True,
    )
    device_ms = sum(r[0] for r in rows)
    log(f"profile: device busy {device_ms:.2f} ms of a {step_ms:.2f} ms step "
        f"({device_ms / step_ms:.1%}); top: "
        + "; ".join(f"{k[:40]} {ms:.2f} ms x{n}" for ms, n, k in rows[:6]))
    return {"device_ms": device_ms, "busy_share": device_ms / step_ms,
            "top": [{"kernel": k, "ms": ms, "count": n} for ms, n, k in rows[:25]]}


def _unaligned(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` whose data starts 4 bytes past a 16-byte
    boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view_as(t)
    view.copy_(t)
    return view


def phase_score() -> dict:
    """The score kernel against its plain version, bit for bit, at the
    simulator's shapes and the edge cases of the chain."""
    from repro_torch.core.selectors import sparsity_to_k
    from repro_torch.kernels import ops
    from repro_torch.kernels import regtopk_score as rs

    leaves = _model_leaves()
    flat = sum(leaves.values())
    # (name, workers, length, y, case, the simulator's full-width round)
    cases = [(path, W, n, 1.0, None, False) for path, n in leaves.items()] + [
        ("flat model", W, flat, 1.0, None, True),
        ("fig3 N=20 J=100", 20, 100, 1.0, None, False),
        ("ragged", W, 3 * 8192 + 17, 1.0, None, False),
        ("flat model y=2", W, flat, 2.0, None, False),
        ("flat model y=1.5", W, flat, 1.5, None, False),
        ("zero denominators", W, leaves["layers.mlp.wg"], 1.0, "zero", False),
        ("all unsent", W, leaves["layers.mlp.wg"], 1.0, "unsent", False),
        ("NaN input", W, leaves["layers.mlp.wg"], 1.0, "nan", False),
        ("unaligned view", W, leaves["layers.mlp.wg"], 1.0, "unaligned", False),
    ]
    gen = torch.Generator().manual_seed(1)
    rows, max_err, main = [], 0.0, None
    for name, n_workers, L, y, case, main_path in cases:
        a, a_prev, s_prev, g_prev = _leaf_inputs(
            L, sparsity_to_k(L, 0.01), gen, workers=n_workers
        )
        if case == "zero":  # a == 0 where the coordinate was sent
            a = torch.where(s_prev > 0, 0.0, a)
        elif case == "unsent":
            s_prev = torch.zeros_like(s_prev)
        elif case == "nan":
            a[:, 5] = float("nan")
        tiles = [ops._tile(x)[0] for x in (a, a_prev, s_prev, g_prev)]
        if case == "unaligned":  # 4 bytes off 16: the kernel's scalar loop
            tiles = [_unaligned(t) for t in tiles]
        kw = dict(omega=1.0 / n_workers, mu=1.0, q=1e9, y=y)
        got = rs.regtopk_score(*tiles, **kw)
        want = rs.regtopk_score_ref(*tiles, **kw)
        torch.cuda.synchronize()
        bad = _bit_mismatches(got, want)
        if bad:
            raise AssertionError(
                f"score {name}: {bad} elements differ from the plain version "
                f"(max |diff| {_abs_diff(got, want):g}); the chain must be "
                "bit-equal"
            )
        if case == "nan" and not bool(torch.isnan(got[:, 0, 5]).all()):
            raise AssertionError("score NaN input: the NaN did not propagate")
        max_err = max(max_err, _abs_diff(got, want))
        ms = median_ms(lambda t=tiles, kw=kw: rs.regtopk_score(*t, **kw))
        plain_ms = median_ms(lambda t=tiles, kw=kw: rs.regtopk_score_ref(*t, **kw))
        n_el = tiles[0].numel()
        bound_ms = 1e3 * max(SCORE_BYTES * n_el / HBM_BYTES_PER_S,
                             SCORE_OPS * n_el / F32_OPS_PER_S)
        row = dict(case=name, workers=n_workers, length=L, padded=n_el, y=y,
                   ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                   bytes_per_s=SCORE_BYTES * n_el / (ms * 1e-3))
        rows.append(row)
        log("score: " + json.dumps(row))
        if main_path:
            main = row
        del a, a_prev, s_prev, g_prev, tiles, got, want
    return {"rows": rows, "max_abs_err": max_err, "per_round": main}


def phase_sim() -> dict:
    """The simulator on the card: Fig. 1, Fig. 3 and the full-width round,
    the score kernel's launches counted over the phase."""
    from repro_torch.kernels import fused_encode as fe
    from repro_torch.kernels import regtopk_score as rs

    fe.fused_candidates.launches = 0
    rs.regtopk_score.launches = 0
    fig1 = sim_fig1()
    fig3 = sim_fig3()
    wide = sim_full_width()
    launches = rs.regtopk_score.launches
    expected = fig1["rounds"] + fig3["rounds"] + wide["rounds"]
    if launches != expected or fe.fused_candidates.launches:
        raise AssertionError(
            f"sim: {launches} score kernel launches (expected {expected}: one "
            "per RegTop-k round with the fastpath on) and "
            f"{fe.fused_candidates.launches} fused_candidates launches"
        )
    log(f"sim: {launches} score kernel launches, one per RegTop-k round with "
        "the fastpath on")
    timing = sim_round_times(wide.pop("timing"))
    return {"fig1": fig1, "fig3": fig3, "full_width": wide, "timing": timing,
            "launches": launches}


def sim_fig1(rounds: int = 60) -> dict:
    """Paper Fig. 1 toy, with the assertions of tests/test_sparsify.py:
    Top-1 stuck for 50 rounds, RegTop-1 (through the score kernel) below
    0.05 and within 0.01 of no sparsification."""
    from repro_torch.core import DistributedSim, SparsifierConfig

    x = torch.tensor([[100.0, 1.0], [-100.0, 1.0]], device=DEVICE)

    def grad_fn(theta, widx):
        xn = x[widx]
        e = torch.exp(-(xn @ theta))[:, None]
        return -e * xn / (1 + e)

    traces = {}
    for kind in ("topk", "regtopk", "none"):
        sim = DistributedSim(
            grad_fn, 2, 2, SparsifierConfig(kind=kind, sparsity=0.5, mu=1.0),
            learning_rate=0.9, fastpath="on", device=DEVICE,
        )
        _, tr = sim.run(torch.tensor([0.0, 1.0]), rounds,
                        trace_fn=lambda th: torch.log(1 + torch.exp(-x @ th)).mean())
        traces[kind] = tr.tolist()
    t = traces
    if not (math.isclose(t["topk"][49], t["topk"][0], rel_tol=1e-6)
            and t["regtopk"][49] < 0.05
            and abs(t["regtopk"][49] - t["none"][49]) < 0.01):
        raise AssertionError(f"fig1: round 49 {[v[49] for v in t.values()]}")
    log(f"sim fig1: loss at round 49: topk {t['topk'][49]:.6f} (round 0 "
        f"{t['topk'][0]:.6f}), regtopk {t['regtopk'][49]:.6f}, none "
        f"{t['none'][49]:.6f}")
    return {"rounds": rounds, **{kind: tr[49] for kind, tr in traces.items()}}


def sim_fig3(rounds: int = 2500) -> dict:
    """Paper Fig. 3 at its published size: N = 20, J = 100, Dn = 500,
    eta = 1e-2, S = 0.4, mu = 16, the optimality gap every round."""
    from repro_torch.core import DistributedSim, SparsifierConfig
    from repro_torch.data import linreg_grad_fn, make_linreg
    from repro_torch.kernels import regtopk_score as rs

    data = make_linreg(42, 20, 100, 500, device=DEVICE)
    runs, traces = {}, {}
    for name, kind, mode in (("regtopk on", "regtopk", "on"),
                             ("regtopk off", "regtopk", "off"),
                             ("topk", "topk", "off")):
        sim = DistributedSim(
            linreg_grad_fn(data), 20, 100,
            SparsifierConfig(kind=kind, sparsity=0.4, mu=16.0),
            learning_rate=1e-2, fastpath=mode, device=DEVICE,
        )
        before = rs.regtopk_score.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fin, tr = sim.run(torch.zeros(100), rounds,
                          trace_fn=lambda th: torch.linalg.norm(th - data.theta_star))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launched = rs.regtopk_score.launches - before
        if launched != (rounds if mode == "on" else 0):
            raise AssertionError(f"fig3 {name}: {launched} kernel launches")
        runs[name] = fin
        traces[name] = tr
        gaps = (float(tr[999]), float(tr[-1]))
        if not all(math.isfinite(g) for g in gaps):
            raise AssertionError(f"fig3 {name}: gaps {gaps}")
        log(f"sim fig3 {name}: gap@1000 {gaps[0]:.6e} gap@2500 {gaps[1]:.6e} "
            f"({rounds} rounds in {seconds:.2f} s, "
            f"{1e3 * seconds / rounds:.3f} ms per round, {launched} launches)")
    on, off = runs["regtopk on"], runs["regtopk off"]
    if not (torch.equal(traces["regtopk on"], traces["regtopk off"])
            and torch.equal(on.theta, off.theta)
            and torch.equal(on.worker_states.s_prev, off.worker_states.s_prev)):
        raise AssertionError("fig3: RegTop-k fastpath on and off differ")
    log(f"sim fig3: RegTop-k fastpath on == off over {rounds} rounds "
        "(traces, final theta and masks bit-equal)")
    return {"rounds": rounds, **{
        name: {"gap@1000": float(tr[999]), "gap@2500": float(tr[-1])}
        for name, tr in traces.items()
    }}


def _flat_model(cfg=None):
    """``(grad_fn, theta0, J)`` of paper-resnet-proxy's flat parameter
    vector, as benchmarks/fig6_nn_proxy.py selects over it: the grad_fn is
    composed here from the port's lm.loss_fn, TokenPipeline and tree
    utilities, one batch shard of the global batch of 32 per worker."""
    from repro_torch import configs
    from repro_torch.data import TokenPipeline
    from repro_torch.models import lm
    from repro_torch.nn.layers import set_fp32_matmul
    from repro_torch.tree import tree_leaves, tree_unflatten

    set_fp32_matmul()
    cfg = cfg or configs.get_config("paper-resnet-proxy")
    params = lm.init(cfg, seed=0, device=DEVICE)
    shapes = [p.shape for p in tree_leaves(params)]
    sizes = [p.numel() for p in tree_leaves(params)]
    batch = TokenPipeline(cfg, 32, 128, seed=1, device=DEVICE).batch_at(0)
    per = 32 // W

    def grad_fn(theta, widx):
        out = []
        for w in widx.tolist():
            leaves = [
                x.view(s).detach().requires_grad_(True)
                for x, s in zip(torch.split(theta, sizes), shapes, strict=True)
            ]
            shard = {key: v[w * per:(w + 1) * per] for key, v in batch.items()}
            loss = lm.loss_fn(tree_unflatten(params, leaves), cfg, shard)[0]
            out.append(torch.cat([g.reshape(-1) for g in
                                  torch.autograd.grad(loss, leaves)]))
        return torch.stack(out)

    theta0 = torch.cat([p.reshape(-1) for p in tree_leaves(params)])
    return grad_fn, theta0, sum(sizes)


def sim_full_width(rounds: int = 5, cfg=None) -> dict:
    """Whole-model selection over paper-resnet-proxy's flat parameter
    vector (``_flat_model``): N = 8 workers, RegTop-k at S = 0.01. The
    fastpath-on run computes the gradients and the off run replays them,
    round by round, so the two see the same gradients even if the
    backward is not deterministic."""
    from repro_torch.core import DistributedSim, SparsifierConfig
    from repro_torch.core.selectors import sparsity_to_k

    grad_fn, theta0, J = _flat_model(cfg)
    widx = torch.arange(W, device=DEVICE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    g0 = grad_fn(theta0, widx)
    torch.cuda.synchronize()
    grad_ms = 1e3 * (time.perf_counter() - t0)
    deterministic = torch.equal(g0, grad_fn(theta0, widx))
    log(f"sim full width: J = {J}, the {W} workers' backward takes {grad_ms:.1f} "
        f"ms (host clock), deterministic: {deterministic}")

    recorded = []

    def record(theta, widx):
        recorded.append(grad_fn(theta, widx))
        return recorded[-1]

    def replay(theta, widx):
        return recorded.pop(0)

    scfg = SparsifierConfig(kind="regtopk", sparsity=0.01)
    sims = {mode: DistributedSim(fn, W, J, scfg, learning_rate=0.05,
                                 aggregation="sparse_allgather", fastpath=mode,
                                 device=DEVICE)
            for mode, fn in (("on", record), ("off", replay))}
    states = {mode: sim.init(theta0) for mode, sim in sims.items()}
    k = sparsity_to_k(J, 0.01)
    for r in range(rounds):
        outs = {mode: sims[mode].step_fn(states[mode]) for mode in ("on", "off")}
        (on, g_on), (off, g_off) = outs["on"], outs["off"]
        if not (torch.equal(on.worker_states.s_prev, off.worker_states.s_prev)
                and torch.equal(g_on, g_off) and torch.equal(on.theta, off.theta)):
            raise AssertionError(f"full width round {r}: fastpath on and off differ")
        sent = on.worker_states.s_prev.sum(dim=1)
        if not (bool(torch.isfinite(g_on).all()) and bool((sent == k).all())):
            raise AssertionError(f"full width round {r}: {sent.tolist()} sent, k={k}")
        states = {"on": on, "off": off}
    log(f"sim full width: fastpath on == off for {rounds} rounds (masks, "
        f"g_agg and theta bit-equal), k = {k} of J = {J} per worker")
    fixed = g0

    def constant(theta, widx):
        return fixed

    timing = {mode: (DistributedSim(constant, W, J, scfg, learning_rate=0.05,
                                    aggregation="sparse_allgather", fastpath=mode,
                                    device=DEVICE),
                     states[mode]) for mode in ("on", "off")}
    return {"rounds": rounds, "J": J, "k": k, "grad_ms": grad_ms,
            "backward_deterministic": deterministic, "timing": timing}


def sim_round_times(timing: dict, reps: int = 5) -> dict:
    """Host-clock milliseconds of one full-width simulator round from the
    same state, the gradient held fixed (the round's own work: score,
    selection, payload, aggregation, update), fastpath on and off in
    turns; then one round of each under the profiler."""
    runs = {mode: (lambda sim=sim, st=st: sim.step_fn(st))
            for mode, (sim, st) in timing.items()}
    for run in runs.values():
        run()
    round_ms, times = turn_times(
        runs, "sim full width: round time (gradient fixed)", reps
    )
    profile = {mode: profile_step(run, round_ms[mode]) for mode, run in runs.items()}
    return {"round_ms": round_ms, "samples": times, "profile": profile}


WIRE_STEPS = 5


def _bits_equal(x: torch.Tensor, y: torch.Tensor) -> bool:
    """Equal dtype, shape and bits (floats compared as int32 bits)."""
    if x.dtype != y.dtype or x.shape != y.shape:
        return False
    if x.dtype == torch.float32:
        x, y = x.view(torch.int32), y.view(torch.int32)
    return torch.equal(x, y)


class _PayloadRecorder:
    """Records every payload ``codec.encode`` returns while installed,
    in call order (``encode_fused`` of every fusing codec calls
    ``encode``, so each leaf's payload is recorded once)."""

    def __init__(self, codec):
        self.codec, self.payloads = codec, []

    def __enter__(self):
        encode = type(self.codec).encode

        def recording(vals, idx, length):
            payload = encode(self.codec, vals, idx, length)
            self.payloads.append(payload)
            return payload

        self.codec.encode = recording
        return self

    def __exit__(self, *exc):
        del self.codec.encode


def _timed_step(step, params, sp_state, batch, reps: int = 3):
    """Run ``step`` from the same state ``reps`` times; returns (the last
    outputs, the median host-clock milliseconds of one step)."""
    times, out = [], None
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step(params, sp_state, batch)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return out, statistics.median(times)


def _model_cfg(args):
    from repro_torch import configs

    cfg = configs.get_config(args.arch)
    return cfg.smoke_variant() if args.smoke else cfg


def _one_step(args, res, dist, table=None):
    """One training step from the state a run ``res`` of ``args`` reached,
    under ``dist``, on a batch that run did not see: (the new sparsifier
    state, the payloads the codec encoded, the plan, the step's median
    host-clock milliseconds, the step as a callable)."""
    from repro_torch.comm.codec import get_codec
    from repro_torch.core import distributed as td
    from repro_torch.data import TokenPipeline
    from repro_torch.optim import make_optimizer
    from repro_torch.tree import tree_leaves

    cfg = _model_cfg(args)
    batch = TokenPipeline(cfg, args.global_batch, args.seq, 1,
                          args.device).batch_at(0)
    plan = td.build_plan(res.params, dist.sparsifier.sparsity, dist, table)
    step = td.make_train_step(cfg, dist, plan, W)
    opt_state = make_optimizer(dist.optimizer).init(res.params)
    with _PayloadRecorder(get_codec(dist.codec)) as rec:
        out, ms = _timed_step(lambda p, s, b: step(p, opt_state, s, b),
                              res.params, res.sp_state, batch)
    return (out[2], rec.payloads[-len(tree_leaves(plan)):], plan, ms,
            lambda: step(res.params, opt_state, res.sp_state, batch))


def _payloads_equal(a: list, b: list) -> bool:
    return len(a) == len(b) and all(
        sorted(x) == sorted(y) and all(_bits_equal(x[k], y[k]) for k in x)
        for x, y in zip(a, b, strict=True))


def _wire_train(name: str, extra: list, steps: int = WIRE_STEPS, table=None):
    """``steps`` full-width training steps with ``TRAIN_ARGS`` and
    ``extra`` flags, kernel 1's launches counted from 0 around the run."""
    from repro_torch.kernels import fused_encode as fe
    from repro_torch.launch import train
    from repro_torch.tree import tree_leaves

    base = [a for a in TRAIN_ARGS if a not in ("--fastpath", "on")]
    args = train.parse_args([*base, "--steps", str(steps), *extra])
    log(f"wire trainer {name}:")
    fe.fused_candidates.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = train.run(args, table=table)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = fe.fused_candidates.launches
    if len(res.losses) != steps or not all(math.isfinite(x) for x in res.losses):
        raise AssertionError(f"wire trainer {name}: losses {res.losses}")
    n_fused = sum(p.fused for p in tree_leaves(res.plan))
    if launches != steps * n_fused:
        raise AssertionError(f"wire trainer {name}: {launches} kernel 1 launches, "
                             f"expected {steps} steps x {n_fused} fused leaves")
    return args, res, {"losses": res.losses, "seconds": seconds,
                       "launches": launches, "fused_leaves": n_fused,
                       "hit_rate": res.counts.hit_rate}


def wire_trainer(smi: str) -> dict:
    """The trainer's new wire paths at full width (see the module
    docstring, phase 8)."""
    from repro_torch.comm import cost
    from repro_torch.comm.fastpath import ThroughputTable
    from repro_torch.core import distributed as td
    from repro_torch.core.sparsify import SparsifierConfig
    from repro_torch.launch import train
    from repro_torch.optim import OptConfig
    from repro_torch.tree import tree_items, tree_leaves

    out, launches = {}, 0

    def dist_of(args, **kw):
        return td.DistConfig(
            sparsifier=SparsifierConfig(kind=args.sparsifier, sparsity=args.sparsity,
                                        mu=args.mu),
            optimizer=OptConfig(learning_rate=args.lr), codec=args.codec,
            collective=args.collective, **kw)

    for codec in ("coo_idx_delta", "coo_q8"):
        args, res, row = _wire_train(codec, ["--codec", codec, "--fastpath", "on"])
        if row["launches"] == 0:
            raise AssertionError(f"wire trainer {codec}: kernel 1 never launched")
        launches += row["launches"]
        (st_on, pay_on, plan, ms_on, run_on), (st_off, pay_off, _, ms_off, _) = (
            _one_step(args, res, dist_of(args, fastpath=mode)) for mode in ("on", "off"))
        if not _payloads_equal(pay_on, pay_off):
            raise AssertionError(f"wire trainer {codec}: fastpath on/off payloads differ")
        for (path, a), (_, b) in zip(tree_items(st_on), tree_items(st_off), strict=True):
            if not (_bits_equal(a.sent_vals, b.sent_vals)
                    and torch.equal(a.sent_idx, b.sent_idx)):
                raise AssertionError(f"wire trainer {codec}: {path} sent_vals differ")
        pred, _ = td.comm_round_bytes(plan, dist_of(args), W)
        meas = sum(
            cost.measured_bytes(args.collective, p.local_len,
                                {k: v[:1] for k, v in pay.items()}, (W,))
            for p, pay in zip(tree_leaves(plan), pay_on, strict=True))
        if meas > 1.05 * pred:
            raise AssertionError(f"wire trainer {codec}: measured {meas} B > "
                                 f"1.05 x predicted {pred} B")
        row.update(step_ms={"on": ms_on, "off": ms_off}, measured_bytes=meas,
                   predicted_bytes=pred, profile=profile_step(run_on, ms_on))
        log(f"wire trainer {codec}: {row['launches']} kernel 1 launches in "
            f"{WIRE_STEPS} steps ({row['fused_leaves']} fused leaves), hit rate "
            f"{row['hit_rate']:.4f}; one step on == off (encoded payloads and "
            f"sent_vals bit-equal); measured {meas} B <= 1.05 x predicted {pred} B "
            f"per worker per round; step {ms_on:.1f} ms on, {ms_off:.1f} ms off "
            f"(host clock; {smi})")
        out[codec] = row

    args, res, row = _wire_train("bitmap_dense",
                                 ["--codec", "bitmap_dense", "--fastpath", "on"])
    if row["launches"] or row["fused_leaves"]:
        raise AssertionError("wire trainer bitmap_dense: fused, but it never fuses")
    *_, row["step_ms"], run = _one_step(args, res, dist_of(args, fastpath="on"))
    row["profile"] = profile_step(run, row["step_ms"])
    log(f"wire trainer bitmap_dense: 0 kernel launches (never fuses), losses "
        f"{res.losses[0]:.4f} -> {res.losses[-1]:.4f}; step {row['step_ms']:.1f} ms "
        f"(host clock; {smi})")
    out["bitmap_dense"] = row

    args, res, row = _wire_train("coord-weights", ["--coord-weights"])
    sent_w = torch.cat([st.sent_w.reshape(-1) for _, st in tree_items(res.sp_state)])
    if bool((sent_w == 1.0).all()) or not bool(torch.isfinite(sent_w).all()):
        raise AssertionError("wire trainer coord-weights: sent_w is all 1")
    *_, row["step_ms"], run = _one_step(args, res, dist_of(args, weighting="coordinate"))
    row["profile"] = profile_step(run, row["step_ms"])
    row["sent_w_not_one"] = float((sent_w != 1.0).float().mean())
    log(f"wire trainer coord-weights: losses {res.losses[0]:.4f} -> "
        f"{res.losses[-1]:.4f}, sent_w != 1 at {row['sent_w_not_one']:.4f} of the "
        f"sent slots; step {row['step_ms']:.1f} ms (host clock; {smi})")
    out["coord_weights"] = row

    table = ThroughputTable.measure(device=DEVICE)
    args, res, row = _wire_train("auto", ["--fastpath", "auto"], table=table)
    launches += row["launches"]
    fused = [path for path, p in tree_items(res.plan) if p.fused]
    log(f"wire trainer auto: ThroughputTable.measure() on this card: fused "
        f"{table.fused_bps:.4e} B/s, unfused {table.unfused_bps:.4e} B/s; auto "
        f"fuses {len(fused)}/{len(tree_leaves(res.plan))} leaves {fused} ({smi})")
    steps = {mode: _one_step(args, res, dist_of(args, fastpath=mode), table)
             for mode in ("auto", "off")}
    if not _payloads_equal(steps["auto"][1], steps["off"][1]):
        raise AssertionError("wire trainer auto: payloads differ from fastpath off")
    row.update(table={"fused_bps": table.fused_bps, "unfused_bps": table.unfused_bps},
               fused_paths=fused,
               step_ms={"auto": steps["auto"][3], "off": steps["off"][3]})
    log(f"wire trainer auto: one step auto == off (payloads bit-equal); step "
        f"{steps['auto'][3]:.1f} ms auto, {steps['off'][3]:.1f} ms off "
        f"(host clock; {smi})")
    out["auto"] = row

    smoke = {}  # coo_fp32's is phase_trainer's
    for codec in ("coo_idx_delta", "bitmap_dense", "coo_q8"):
        small = ["--smoke", "--workers", "2", "--steps", "3", "--seq", "32",
                 "--fastpath", "on", "--log-every", "100", "--codec", codec]
        gpu = train.run(train.parse_args([*small, "--device", DEVICE])).losses
        cpu = train.run(train.parse_args([*small, "--device", "cpu"])).losses
        for g, c in zip(gpu, cpu, strict=True):
            if abs(g - c) > 1e-4 * abs(c):
                raise AssertionError(f"wire smoke {codec}: card {gpu} vs CPU {cpu}")
        smoke[codec] = {"card": gpu, "cpu": cpu}
    log("wire trainer: smoke run per codec on the card matches the CPU run "
        "(losses within 1e-4 relative)")
    out["smoke"] = smoke
    out["launches"] = launches
    return out


def _paired_sims(grad_fn, theta0, J, rounds, kw_a, kw_b, check, label):
    """Two simulators over the same gradients (``a`` computes them, ``b``
    replays them) for ``rounds`` rounds; ``check(r, (state, g_agg) of a,
    of b)`` raises on a difference. Returns the two simulators and their
    last states."""
    from repro_torch.core import DistributedSim, SparsifierConfig

    recorded = []

    def record(theta, widx):
        recorded.append(grad_fn(theta, widx))
        return recorded[-1]

    def replay(theta, widx):
        return recorded.pop(0)

    scfg = SparsifierConfig(kind="regtopk", sparsity=0.01)
    sims = [DistributedSim(fn, W, J, scfg, learning_rate=0.05, device=DEVICE, **kw)
            for fn, kw in ((record, kw_a), (replay, kw_b))]
    states = [sim.init(theta0) for sim in sims]
    for r in range(rounds):
        outs = [sim.step_fn(st) for sim, st in zip(sims, states, strict=True)]
        for st, g in outs:
            if not bool(torch.isfinite(g).all()):
                raise AssertionError(f"wire sim {label} round {r}: non-finite g_agg")
        check(r, *outs)
        states = [o[0] for o in outs]
    return sims, states


def _round_ms(sim, state, g_fixed, reps: int = 5) -> dict:
    """Host-clock milliseconds of one round from ``state`` with the
    gradient held fixed (the round's own work), and one such round under
    the profiler."""
    sim.grad_fn = lambda theta, widx: g_fixed
    sim.step_fn(state)
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sim.step_fn(state)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    ms = statistics.median(times)
    return {"ms": ms, "profile": profile_step(lambda: sim.step_fn(state), ms)}


def wire_sim(smi: str, rounds: int = 5, cfg=None) -> dict:
    """The simulator's new wire paths at full width (phase 8); ``cfg``
    replaces paper-resnet-proxy for a rehearsal on the CPU."""
    from repro_torch.core import DistributedSim, SparsifierConfig
    from repro_torch.kernels import regtopk_score as rs

    grad_fn, theta0, J = _flat_model(cfg)
    g0 = grad_fn(theta0, torch.arange(W, device=DEVICE))
    out = {}

    def same(fields):
        def check(r, a, b):
            (sa, ga), (sb, gb) = a, b
            pairs = {"g_agg": (ga, gb), "theta": (sa.theta, sb.theta),
                     "eps": (sa.worker_states.eps, sb.worker_states.eps),
                     "masks": (sa.worker_states.s_prev, sb.worker_states.s_prev)}
            for f in fields:
                if not _bits_equal(*pairs[f]):
                    raise AssertionError(f"wire sim round {r}: {f} differ")
        return check

    rs.regtopk_score.launches = 0
    kw = dict(codec="coo_q8", aggregation="sparse_allgather")
    sims, states = _paired_sims(grad_fn, theta0, J, rounds, {**kw, "fastpath": "on"},
                                {**kw, "fastpath": "off"},
                                same(("g_agg", "theta", "eps", "masks")), "coo_q8")
    launches = rs.regtopk_score.launches
    if launches != rounds:
        raise AssertionError(f"wire sim coo_q8: {launches} score launches, "
                             f"expected {rounds}")
    out["coo_q8"] = {"rounds": rounds, "launches": launches,
                     "round": {m: _round_ms(s, st, g0) for m, s, st in
                               zip(("on", "off"), sims, states, strict=True)}}
    log(f"wire sim coo_q8: fastpath on == off for {rounds} rounds (theta, eps, "
        f"masks and g_agg bit-equal), {launches} score launches; round "
        + ", ".join(f"{m} {r['ms']:.2f} ms" for m, r in out["coo_q8"]["round"].items())
        + f" (gradient fixed, host clock; {smi})")

    before = rs.regtopk_score.launches
    kw = dict(aggregation="sparse_allgather", weighting="coordinate")
    sims, states = _paired_sims(grad_fn, theta0, J, rounds, {**kw, "fastpath": "off"},
                                {**kw, "fastpath": "auto"},
                                same(("g_agg", "theta", "eps", "masks")), "coordinate")
    if rs.regtopk_score.launches != before:
        raise AssertionError("wire sim coordinate: auto launched the score kernel")
    den = states[0].w_agg_prev
    if den is None or bool((den == 1.0).all()):
        raise AssertionError("wire sim coordinate: no sender mass recorded")
    out["coordinate"] = {"rounds": rounds,
                         "round": _round_ms(sims[0], states[0], g0),
                         "den_max": float(den.max())}
    log(f"wire sim coordinate: {rounds} rounds, auto == off (no score launch), "
        f"sender mass up to {out['coordinate']['den_max']:.4f}; round "
        f"{out['coordinate']['round']['ms']:.2f} ms (gradient fixed, host clock; {smi})")

    kw = dict(codec="coo_idx_delta", fastpath="off")
    sims, states = _paired_sims(
        grad_fn, theta0, J, rounds, {**kw, "collective": "hierarchical", "dp_shape": (2, 4)},
        {**kw, "collective": "sparse_allgather"}, same(("g_agg", "theta", "eps")),
        "hierarchical")
    out["hierarchical"] = {"rounds": rounds,
                           "round": _round_ms(sims[0], states[0], g0)}
    log(f"wire sim hierarchical (coo_idx_delta, dp 2 x 4): == sparse_allgather for "
        f"{rounds} rounds (g_agg, theta, eps bit-equal); round "
        f"{out['hierarchical']['round']['ms']:.2f} ms (gradient fixed, host clock; "
        f"{smi})")

    wire = {}
    for codec in ("coo_fp32", "coo_idx_delta", "bitmap_dense", "coo_q8"):
        for coll in ("sparse_allgather", "hierarchical", "dense_allreduce"):
            est = DistributedSim(None, W, J, SparsifierConfig(sparsity=0.01),
                                 codec=codec, collective=coll, dp_shape=(2, 4),
                                 device=DEVICE).wire_bytes_per_round()
            wire[f"{codec}/{coll}"] = {"bytes": est.bytes_on_wire,
                                      "messages": est.n_messages,
                                      "seconds": est.seconds}
    for name, row in wire.items():
        log(f"wire sim wire_bytes_per_round {name} (dp 2 x 4, default link): "
            + json.dumps(row))
    out["wire_bytes_per_round"] = wire
    out["launches"] = launches
    return out


def phase_wire(smi: str) -> dict:
    return {"trainer": wire_trainer(smi), "sim": wire_sim(smi)}


def ab_times() -> dict:
    """Kernel 1's device time per training step (every leaf of the main
    path, W = 8, the trainer's budgets) and ``block_topk_candidates``' at
    full width (m = 16), with whatever ``repro_torch`` is on ``sys.path``:
    only calls that every tree of the port has."""
    from repro_torch.comm import fastpath as fp
    from repro_torch.core.selectors import sparsity_to_k
    from repro_torch.kernels import block_topk as bt
    from repro_torch.kernels import fused_encode as fe
    from repro_torch.kernels import ops
    from repro_torch.kernels import regtopk_score as rs

    gen = torch.Generator().manual_seed(0)
    leaves = _model_leaves()
    per_leaf = {}
    for path, L in leaves.items():
        k = sparsity_to_k(L, 0.01)
        kw = dict(omega=1.0 / W, mu=1.0, q=1e9, y=1.0,
                  m=fp.candidate_budget(L, k))
        tiles = [ops._tile(x)[0] for x in _leaf_inputs(L, k, gen)]
        per_leaf[path] = median_ms(
            lambda t=tiles, kw=kw: fe.fused_candidates(*t, **kw))
    xs = _leaf_inputs(sum(leaves.values()), FULL_K[1], gen, workers=1)
    st = ops._tile(rs.score_chain(*xs, omega=1.0 / W, mu=1.0, q=1e9, y=1.0))[0]
    block_ms = median_ms(lambda: bt.block_topk_candidates(st, SELECT_M))
    return {"fused_candidates_per_step_ms": sum(per_leaf.values()),
            "block_topk_candidates_full_width_ms": block_ms,
            "fused_candidates_per_leaf_ms": per_leaf}


def phase_ab(parent: Path) -> dict:
    """Kernels 1 and 5 of a checkout of the parent commit against this
    tree's, on this card, in turns (parent, change, change, parent): each
    turn a fresh process that builds that tree's kernels (into its own
    ``build/``) and runs ``ab_times`` on its modules."""
    trees = {"parent": parent.resolve(), "change": ROOT}
    samples = {name: [] for name in trees}
    for name in ("parent", "change", "change", "parent"):
        out = subprocess.run(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--ab-tree",
             str(trees[name])],
            capture_output=True, text=True, timeout=600,
        )
        if out.returncode != 0:
            raise AssertionError(f"A/B turn {name} failed:\n{out.stdout}\n{out.stderr}")
        samples[name].append(json.loads(out.stdout.strip().splitlines()[-1]))
        log(f"A/B {name}: {json.dumps(samples[name][-1])}")
    return {"order": ["parent", "change", "change", "parent"], "samples": samples}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--details", type=Path, default=None,
                    help="write every phase's results to this JSON file")
    ap.add_argument("--parent", type=Path, default=None,
                    help="a checkout of the parent commit: time kernels 1 "
                         "and 5 of both trees in turns (into --details)")
    ap.add_argument("--ab-tree", type=Path, default=None,
                    help="build the kernels of this checkout, print "
                         "ab_times() of its modules as JSON and stop")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    tree = args.ab_tree.resolve() if args.ab_tree else ROOT
    sys.path.insert(0, str(tree / "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)

    if args.ab_tree is not None:
        phase_build()
        print(json.dumps(ab_times()), flush=True)
        return 0

    device_name, smi = phase_device()
    builds = phase_build()
    kernels = phase_kernels()
    score = phase_score()
    select = phase_select()
    trainer = phase_trainer()
    sim = phase_sim()
    wire = phase_wire(smi)
    ab = phase_ab(args.parent) if args.parent is not None else None
    per_step = kernels["per_step"]
    per_round = score["per_round"]
    line = {"kernels": [{
        "name": "fused_candidates",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_encode.cu",
        "replaces": "src/repro/kernels/fused_encode.py:111",
        "launches": trainer["launches"] + wire["trainer"]["launches"],
        "max_abs_err": kernels["max_abs_err"],
        "ms": per_step["ms"],
        "plain_ms": per_step["plain_ms"],
        "bound_ms": per_step["bound_ms"],
        "bound_by": "bytes",
        "library_ms": per_step["library_ms"],
    }, {
        "name": "regtopk_score",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/regtopk_score.cu",
        "replaces": "src/repro/kernels/regtopk_score.py:82",
        "launches": sim["launches"] + wire["sim"]["launches"],
        "max_abs_err": score["max_abs_err"],
        "ms": per_round["ms"],
        "plain_ms": per_round["plain_ms"],
        "bound_ms": per_round["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
    }]}
    wide = select["times"]["full width"]["kernels"]
    for kernel, source, replaces in (
        ("count_above", "threshold_topk.cu", "threshold_topk.py:54"),
        ("global_max", "threshold_topk.cu", "threshold_topk.py:70"),
        ("block_topk_candidates", "block_topk.cu", "block_topk.py:48"),
    ):
        line["kernels"].append({
            "name": kernel,
            "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{source}",
            "replaces": f"src/repro/kernels/{replaces}",
            "launches": select["launches"][kernel],
            "max_abs_err": select["max_abs_err"][kernel],
            "ms": wide[kernel]["ms"],
            "plain_ms": wide[kernel]["plain_ms"],
            "bound_ms": wide[kernel]["bound_ms"],
            "bound_by": "bytes",
            "library_ms": wide[kernel]["library_ms"],
        })
    if args.details is not None:
        args.details.parent.mkdir(parents=True, exist_ok=True)
        args.details.write_text(json.dumps(
            {"device": device_name, "nvidia_smi": smi, "build_seconds": builds,
             "kernels": kernels, "score": score, "select": select,
             "trainer": trainer, "sim": sim, "wire": wire, "ab": ab,
             "kernels_line": line},
            indent=1,
        ))
    print(json.dumps(line), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
