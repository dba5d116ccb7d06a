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
4. score    — the RegTop-k score kernel against its plain PyTorch version,
              bit for bit, at every leaf shape of paper-resnet-proxy with
              W = 8, the model's flat length (the simulator at full width),
              Fig. 3's N = 20 x J = 100, a ragged length, y = 2 and 1.5,
              zero denominators, an all-unsent state and a NaN input; each
              timed beside its plain version and its bound;
5. trainer  — the port's trainer (``repro_torch.launch.train``) on
              paper-resnet-proxy at full width, W = 8, RegTop-k at S = 0.01,
              fastpath on, for 10 steps: finite losses, one kernel launch
              per fused leaf per step, the certificate hit rate, one step
              held against the fastpath off, and a small run held against
              the same run on the CPU;
6. sim      — the port's simulator (``repro_torch.core.DistributedSim``):
              the paper's Fig. 1 toy with its assertions; Fig. 3 at its
              published size (N = 20, J = 100, 2500 rounds), RegTop-k with
              the fastpath on and off equal bit for bit and one score kernel
              launch per round; and whole-model selection at full width
              (N = 8, J = 4,458,752, RegTop-k at S = 0.01, 5 rounds), fastpath
              on against off round by round, with the round times and the
              device's busy share.

Each kernel's launch count is set to 0 just before the path that runs it
(trainer: ``fused_candidates``; sim: ``regtopk_score``) and read just
after. The line before the last is the card's nvidia-smi line; before it,
the ``kernels`` JSON line. The last line is the device JSON.
``--details FILE`` also writes every phase's results to FILE as JSON.
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
        if err != 0.0:
            raise AssertionError(
                f"{name}: candidate scores/values differ from the plain "
                f"version by {err:g}; the score chain must be bit-equal"
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
    return {"rows": rows, "max_abs_err": max_err, "per_step": totals}


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
            "profile": profile, "winners_per_tile": crowd}


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


def sim_full_width(rounds: int = 5, cfg=None) -> dict:
    """Whole-model selection over paper-resnet-proxy's flat parameter
    vector, as benchmarks/fig6_nn_proxy.py does: N = 8 workers, RegTop-k
    at S = 0.01. The grad_fn is composed here from the port's lm.loss_fn,
    TokenPipeline and tree utilities. The fastpath-on run computes the
    gradients and the off run replays them, round by round, so the two
    see the same gradients even if the backward is not deterministic."""
    from repro_torch import configs
    from repro_torch.core import DistributedSim, SparsifierConfig
    from repro_torch.core.selectors import sparsity_to_k
    from repro_torch.data import TokenPipeline
    from repro_torch.models import lm
    from repro_torch.nn.layers import set_fp32_matmul
    from repro_torch.tree import tree_leaves, tree_unflatten

    set_fp32_matmul()
    cfg = cfg or configs.get_config("paper-resnet-proxy")
    params = lm.init(cfg, seed=0, device=DEVICE)
    shapes = [p.shape for p in tree_leaves(params)]
    sizes = [p.numel() for p in tree_leaves(params)]
    J = sum(sizes)
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--details", type=Path, default=None,
                    help="write every phase's results to this JSON file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)

    name, smi = phase_device()
    builds = phase_build()
    kernels = phase_kernels()
    score = phase_score()
    trainer = phase_trainer()
    sim = phase_sim()
    per_step = kernels["per_step"]
    per_round = score["per_round"]
    line = {"kernels": [{
        "name": "fused_candidates",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_encode.cu",
        "replaces": "src/repro/kernels/fused_encode.py:111",
        "launches": trainer["launches"],
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
        "launches": sim["launches"],
        "max_abs_err": score["max_abs_err"],
        "ms": per_round["ms"],
        "plain_ms": per_round["plain_ms"],
        "bound_ms": per_round["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
    }]}
    if args.details is not None:
        args.details.parent.mkdir(parents=True, exist_ok=True)
        args.details.write_text(json.dumps(
            {"device": name, "nvidia_smi": smi, "build_seconds": builds,
             "kernels": kernels, "score": score, "trainer": trainer,
             "sim": sim, "kernels_line": line},
            indent=1,
        ))
    print(json.dumps(line), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
