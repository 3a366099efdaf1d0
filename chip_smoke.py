#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--out DIR]

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` (nvcc,
first use), holds each against its plain PyTorch version at the shapes
its path gives it, then drives the port's paths at the paper's data scale —
Forest CoverType's 581,012 rows × 10 attributes: the fused megastep
(``build_index`` → ``knn_join_batched(megastep=True)``), the int8
quantized tier (``build_index(quantize="int8")`` →
``knn_join_batched(quantized=True)``), both over all of R in 4096-query
batches, the paper's host-planned one-shot ``knn_join`` on a sample
of R, the mutable segmented index, and kNN-LM retrieval over a mutable
``Datastore`` — and the LM serving path at full width (llama3.2-3b in
bf16 through ``BatchedServer`` with the kNN-LM hook), and checks each
against a float64 brute force and against each other. Phases:

1. card, versions, kernel build;
2. K-A (nearest pivot) vs its plain version, n = 581,012, M = 256, d = 10;
3. K-G (scheduled gather top-k) vs its plain version on one 4096-query
   bucket with the schedule the megastep's stage 3 made for it and ~1 %
   of the rows dead, with its split count;
4. the serving path, with both kernels' launch counters reset before it
   and read after it (each must be > 0);
5. the join against the float64 brute force on 2048 sampled queries;
6. one steady-state ``join_batch_device`` under
   ``torch.cuda.set_sync_debug_mode("error")``, then its step time, and
   the device's busy share (``torch.profiler``) of a steady-state step
   and of a 32-batch ``knn_join_batched``;
7. K-Q (int8 coarse scan) vs its plain version on one 4096-query
   bucket, with the schedule and θ the quant engine's stages 1–3 made
   for it and ~1 % of the rows dead: lb bit-equal, positions equal;
8. the quantized path, counted (K-Q must launch; certification
   failures re-run through the host path's K-G), against the brute
   force and bitwise against phase 4's distances; one steady-state quant
   step under the sync debug mode, its time and profile, and the
   profile of a 32-batch quantized join;
9. the host-planned ``knn_join`` (pivots from R, gather reducer) on
   ``HOST_ROWS`` queries, counted (K-A and K-G must launch), and the
   pruned and dense reducers on smaller samples, each against the brute
   force and bitwise against the megastep on the same index;
10. K-D (dense top-k) vs its plain version: 4,096 centered queries over
   the 522,911 base rows (d = 10, k = 10), the same with a seeded 50 %
   visit mask, and 256 queries over 262,144 Gaussian keys of d = 1,024
   (k = 8), with ``torch.topk(torch.cdist(...))`` timed beside it;
11. the mutable index: ``MutableIndex.build`` over the base rows, the
   other 58,101 rows inserted in waves of 4,096 (16 segments), then 48
   deletes (θ finite), 5,810 (θ = +inf) and ``compact``; in each stage
   the megastep join of all of R, counted (one K-G launch per batch),
   exact against the float64 brute force over the live rows and bitwise
   equal to a megastep over a fresh index of the survivors; in the
   first stage also the host route and the quantized route, bitwise
   equal to it, and a 16-segment step under the sync debug mode; in
   the second (whose deletes take the 80 nearest rows of 4 probe
   queries) the host route again, its over-fetch asking K-G for
   thousands of rows;
12. kNN-LM retrieval: a ``Datastore`` over the base rows, 16 decode
   steps of 4,096 queries through both ``knn_logits`` routes (K-D
   launched once a step), with 1,024 entries added and 16 removed
   between steps and a ``compact`` after step 8; each step's join route
   exact, the routes' distances and log-probabilities in agreement;
13. the shapes the kernels refused before: K-A at d = 3,072, K-G at d =
   256 / 1,024 (65,536 Gaussian rows) and at k = 100 / 1,024 (phase 3's
   bucket), K-D at k = 128 (phase 10 (a)), K-Q at d = 256 and mp =
   1,024 — each against its plain version — and K-G's widest register
   form (d = 128, k = 64, 65,536 Gaussian rows);
14. the LM serving path: K-F (flash attention) vs its plain version at
   the prefill, windowed and decode shapes and at d = 192, with SDPA
   timed beside it and each shape's route and split count printed, and
   the tensor-core instructions in K-F's SASS counted (none fails);
   ``BatchedServer`` + ``make_knn_hook`` over a 1,048,576-key
   ``Datastore``, 16 requests of 512-2,048 tokens, batch 8, 32 greedy
   tokens, counted (K-F once per layer per forward, K-G every decode
   step, K-A in the build), every retrieval exact against float64,
   every layer's K-F output of one prefill and one decode step against
   the plain version; the reduced model on the card and the CPU with
   the same weights (logits within 2e-5 + 2e-5·|logit|, tokens equal).

Every time printed stands beside the card's name and power limit. The
line before the last two is one JSON object with each kernel's launches,
error, times and bound; the line before the last is the card's name and
power limit; the last is ``{"ok": true, "device": {...}}``. Any failure
exits non-zero before those lines, with its message on stdout and stderr
(also without a card, or where the script stands alone, away from the
repository's ``src/``). Long reports (nvcc's ``ptxas``
output, the two profiles by kernel) go to ``--out`` (default
``build/chip_smoke/``). Needs one card, no network; imports nothing of
JAX.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
N_ROWS = 581_012          # UCI Covertype
N_BASE = 522_911          # the mutable index's and datastore's base (90 %)
DIM = 10
DEAD_A, DEAD_TOTAL = 48, N_ROWS // 100    # phase 11's stages A and B
LM_QUERIES, LM_KEYS, LM_DIM = 256, 262_144, 1024   # phase 10 (c)
DECODE_STEPS, ADD_ROWS, REMOVE_IDS = 16, 1024, 16  # phase 12
PROBES, PROBE_DEAD = 4, 80  # phase 11 stage B: the over-fetch probes
CAP_ROWS = 65_536           # phase 13: Gaussian rows of the wide shapes
LM_ARCH = "llama3.2-3b"     # phase 14: the LM serving path at full width
LM_REQUESTS, LM_BATCH, LM_NEW = 16, 8, 32
LM_PROMPT = (512, 2048)     # prompt lengths, seeded
LM_STORE_KEYS, LM_STORE_DIM = 1_048_576, 32   # the kNN-LM datastore
BUCKET = 4096
HOST_ROWS = 65_536        # R sample of the host-planned gather path
PRUNED_ROWS = 512         # R samples of the pruned and dense reducers
DENSE_ROWS = 2048
DEV = "cuda"
H100_HBM_BYTES_S = 3.35e12    # H100 SXM data sheet
H100_FP32_FLOPS_S = 67e12     # fp32 on CUDA cores, no tensor cores
H100_INT8_OPS_S = 1979e12     # int8 tensor-core peak (dense)
H100_BF16_FLOPS_S = 989e12    # bf16 tensor-core peak (dense)


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


def cpu_line() -> str:
    """The host CPU's model name (``/proc/cpuinfo``), where Linux gives it."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return "CPU model not known"


def time_ms(fn, *, warmup: int = 2, iters: int = 10) -> float:
    """Mean device time of ``fn()`` over ``iters`` launches (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(n_bytes: float, flops: float,
          int8_ops: float = 0.0) -> tuple[float, str]:
    """The least time for the work: bytes over the HBM rate, or fp32
    operations and int8 operations over their peak rates, whichever is
    larger."""
    t_b = n_bytes / H100_HBM_BYTES_S * 1e3
    t_f = (flops / H100_FP32_FLOPS_S + int8_ops / H100_INT8_OPS_S) * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def pair_tol(a2, b2, d: int):
    """Limit on |d²_kernel − d²_plain| for a pair of rows with squared
    norms a2, b2 (float64 tensors). Each version sums the expanded form
    ‖a‖²+‖b‖²−2a·b in fp32 in its own order, off the exact d² by at most
    (2d+4)·u·(a2+b2) (u = 2⁻²⁴), and its √ output rounds d² by at most
    4u·(a2+b2) more; the limit is the sum of both versions' bounds."""
    return (a2 + b2) * (2 * (2 * d + 8)) * 2.0 ** -24


def check_runs(torch, what: str, q, s, d_k, p_k, d_p, p_p):
    """A kernel's top-k run against its plain version's on the same
    (queries ``q``, rows ``s``): empty slots equal, each slot's d² within
    its pair's limit (:func:`pair_tol`), and positions equal except at
    near-ties — each position's exact d² sits at its rank's order
    statistic within the limit, in both runs (the kernel's exact d² is
    off its own d² by half of the limit, and that off the plain
    version's by the limit). Returns ``(share of the limit used, share
    of equal positions, max |dist err|, the limits of the full slots)``.
    """
    full = p_p >= 0
    check(bool((full == (p_k >= 0)).all()),
          f"{what}: empty slots differ from the plain version")
    pk, pp = p_k.long().clamp(min=0), p_p.long().clamp(min=0)
    q64 = q.double()
    sk, sp = s[pk].double(), s[pp].double()              # (n, k, d)
    tol = pair_tol((q64 * q64).sum(1)[:, None],
                   torch.maximum((sk * sk).sum(-1), (sp * sp).sum(-1)),
                   q.shape[1])
    d2_k, d2_p = d_k.double() ** 2, d_p.double() ** 2
    used = float(torch.where(full, (d2_k - d2_p).abs() / tol, 0.0).max())
    check(used <= 1.0, f"{what}: run distances disagree with the plain "
          f"version")
    ex_k = ((q64[:, None, :] - sk) ** 2).sum(-1)
    ex_p = ((q64[:, None, :] - sp) ** 2).sum(-1)
    check(bool((((ex_k - d2_p).abs() <= 1.5 * tol)
                & ((ex_p - d2_p).abs() <= 0.5 * tol) | ~full).all()),
          f"{what}: positions differ beyond near-ties")
    same = float((p_k == p_p).double().mean())
    fin = torch.isfinite(d_p)
    err = float((d_k[fin] - d_p[fin]).abs().max()) if bool(fin.any()) \
        else 0.0
    return used, same, err, tol[full]


def tol_text(tol) -> str:
    return (f"limit median {float(tol.median()):.3e}, max "
            f"{float(tol.max()):.3e} in d²")


def phase_assign(card, torch, rt, s_dev, pivots):
    """K-A vs its plain version at the slice's shapes."""
    from repro_torch.kernels import assign as ka
    n, d = s_dev.shape
    m = pivots.shape[0]
    pid_k, dist_k = ka.assign_cuda(s_dev, pivots)
    pid_p, dist_p = ka.assign_plain(s_dev, pivots)
    torch.cuda.synchronize()
    x64 = s_dev.double()
    p64 = pivots.double()
    p2 = (p64 * p64).sum(1)
    tol = pair_tol((x64 * x64).sum(1), torch.maximum(p2[pid_k.long()],
                                                     p2[pid_p.long()]), d)
    d2_k, d2_p = dist_k.double() ** 2, dist_p.double() ** 2
    used = float(((d2_k - d2_p).abs() / tol).max())
    check(used <= 1.0,
          "K-A: distances disagree with the plain version beyond tolerance")
    diff = pid_k != pid_p
    n_diff = int(diff.sum())
    if n_diff:
        # near-ties only: both picks' exact d² within the tolerance
        rows = diff.nonzero()[:, 0]
        ex_k = ((x64[rows] - p64[pid_k[rows].long()]) ** 2).sum(1)
        ex_p = ((x64[rows] - p64[pid_p[rows].long()]) ** 2).sum(1)
        check(bool(((ex_k - ex_p).abs() <= tol[rows]).all()),
              f"K-A: {n_diff} pivot ids differ beyond near-ties")
    err = float((dist_k - dist_p).abs().max())
    ms = time_ms(lambda: ka.assign_cuda(s_dev, pivots), iters=20)
    plain_ms = time_ms(lambda: ka.assign_plain(s_dev, pivots), iters=5)
    b_ms, b_by = bound(4.0 * (n * d + m * d + 2 * n),
                       float(n) * m * (2 * d + 3))
    print(f"[{card}] K-A assign n={n} m={m} d={d}: ids differ at {n_diff} "
          f"near-tie rows, max |dist err| {err:.3e}, max |d² err| "
          f"{used:.3e} of its pair's tolerance ({tol_text(tol)}); kernel "
          f"{ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})",
          flush=True)
    return dict(name="assign", route="cuda",
                source="src/repro_torch/csrc/assign.cu",
                replaces="src/repro/kernels/assign.py:23",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None)


def gather_inputs(torch, rt, s_np, r_np, cfg):
    """K-G's inputs on one bucket at the megastep's shapes: the centered
    queries and rows, the schedule and counts stage 3 made for them, and
    an alive mask with ~1 % of the rows dead."""
    import numpy as np
    from repro_torch.core.megastep import assign_bounds_schedule
    idx = rt.build_index(s_np, cfg, device=DEV)
    eng = rt.MegastepEngine(idx, cfg, device=DEV)
    pl = eng.payload()
    q, n_valid = eng.enqueue(r_np[:BUCKET])
    _, qcs, _, _, sched, cnt = assign_bounds_schedule(q, n_valid, pl,
                                                      k=cfg.k, bm=cfg.tile_r)
    rng = np.random.default_rng(7)
    alive = pl.alive.clone()
    dead = torch.as_tensor(rng.choice(idx.n_s, idx.n_s // 100,
                                      replace=False), device=DEV)
    alive[dead] = 0.0
    return dict(qcs=qcs, s_c=pl.s_c, sched=sched, cnt=cnt, alive=alive,
                bm=cfg.tile_r, bn=cfg.tile_s)


def gather_case(card, torch, what: str, g: dict, k: int, *,
                plain_iters: int = 3) -> dict:
    """K-G vs its plain version on ``gather_inputs`` asking for ``k``:
    the run checks of :func:`check_runs`, no dead row in a run, times
    and the bound of these inputs' work."""
    from repro_torch.kernels import distance_topk as kg
    qcs, s_c, sched, cnt, alive = (g["qcs"], g["s_c"], g["sched"], g["cnt"],
                                   g["alive"])
    bm, bn = g["bm"], g["bn"]
    args = (qcs, s_c, k, sched, cnt)
    kw = dict(alive=alive, bm=bm, bn=bn)
    d_k, p_k = kg.distance_topk_gather_cuda(*args, **kw)
    plan = kg.last_plan
    d_p, p_p = kg.distance_topk_gather_plain(*args, **kw)
    torch.cuda.synchronize()
    full = p_p >= 0
    check(not bool(((alive[p_k.long().clamp(min=0)] <= 0) & full).any()),
          f"K-G ({what}): a dead row entered the kernel's runs")
    used, same, err, tol = check_runs(torch, f"K-G ({what})", qcs, s_c, d_k,
                                      p_k, d_p, p_p)
    del d_k, p_k, d_p, p_p
    ms = time_ms(lambda: kg.distance_topk_gather_cuda(*args, **kw), iters=20)
    plain_ms = time_ms(lambda: kg.distance_topk_gather_plain(*args, **kw),
                       warmup=1, iters=plain_iters)
    nr_tiles, ns_tiles = sched.shape[0], s_c.shape[0] // bn
    counts = cnt.long()
    slot = torch.arange(sched.shape[1], device=DEV)[None, :]
    visited = sched.long()[slot < counts[:, None]]       # (Σ cnt,) tiles
    live_per_tile = (alive.reshape(ns_tiles, bn) > 0).sum(1)
    pairs = float(bm * live_per_tile[visited].sum())
    tiles = torch.unique(visited)
    d = qcs.shape[1]
    n_bytes = (4.0 * qcs.numel() + tiles.numel() * bn * (4.0 * d + 4.0)
               + 4.0 * (int(counts.sum()) + nr_tiles) + 8.0 * qcs.shape[0] * k)
    b_ms, b_by = bound(n_bytes, pairs * (2 * d + 3))
    frac = float(counts.sum()) / (nr_tiles * ns_tiles)
    print(f"[{card}] K-G gather top-k ({what}) bucket={qcs.shape[0]} d={d} "
          f"k={k} bm={bm} bn={bn}, {plan.splits} splits of {plan.per} "
          f"schedule slots, {plan.warps} warps of {plan.qw} queries a block: "
          f"visited-tile "
          f"fraction {frac:.4f}, "
          f"positions equal {same:.6f} (rest near-ties), max |dist err| "
          f"{err:.3e}, max |d² err| {used:.3e} of its pair's tolerance "
          f"({tol_text(tol)}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"bound {b_ms:.4f} ms ({b_by})", flush=True)
    return dict(shape=what, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=None,
                splits=plan.splits)


def phase_gather(card, torch, rt, s_np, r_np, cfg):
    """K-G vs its plain version on one bucket at the megastep's shapes."""
    from repro_torch.kernels.sorted_merge import next_pow2
    g = gather_inputs(torch, rt, s_np, r_np, cfg)
    row = dict(name="distance_topk_gather", route="cuda",
               source="src/repro_torch/csrc/gather_topk.cu",
               replaces="src/repro/kernels/distance_topk.py:189")
    case = gather_case(card, torch, "Forest bucket", g, next_pow2(cfg.k))
    row.update({key: case[key] for key in ("max_abs_err", "ms", "plain_ms",
                                           "bound_ms", "bound_by",
                                           "library_ms")})
    return row, g


def phase_quant(card, torch, rt, idx, r_np, cfg, *, plain_iters: int = 3):
    """K-Q vs its plain version on one bucket at the quant path's shapes:
    the schedule and θ its stages 1–3 made, ~1 % of the rows dead."""
    import numpy as np
    from repro_torch.core.bounds import pad_theta
    from repro_torch.core.megastep import assign_bounds_schedule
    from repro_torch.kernels import quant_topk as kq
    from repro_torch.quant.engine import quantize_queries

    eng = rt.QuantMegastepEngine(idx, cfg, device=DEV)
    pl = eng.payload()
    q, n_valid = eng.enqueue(r_np[:BUCKET])
    bm, bn, mp = cfg.tile_r, cfg.tile_s, eng.mp
    qs, _, _, th_q, sched, cnt = assign_bounds_schedule(q, n_valid, pl,
                                                        k=cfg.k, bm=bm)
    qi, qsc, qe = quantize_queries(qs)
    rng = np.random.default_rng(8)
    alive = pl.alive.clone()
    dead = torch.as_tensor(rng.choice(idx.n_s, idx.n_s // 100,
                                      replace=False), device=DEV)
    alive[dead] = 0.0
    args = (qi, qsc, qe, pad_theta(th_q).contiguous(), pl.sq, pl.sscale,
            pl.seps, alive, mp, sched, cnt)
    lb_k, p_k = kq.quant_coarse_gather_cuda(*args, bm=bm, bn=bn)
    lb_p, p_p = kq.quant_coarse_sched_plain(*args, bm=bm, bn=bn)
    torch.cuda.synchronize()
    check(torch.equal(lb_k.view(torch.int32), lb_p.view(torch.int32)),
          "K-Q: lb not bit-equal to the plain version")
    # positions: equal, except where lb ties at the run's last slot
    diff = p_k != p_p
    tail_tie = lb_k == lb_k[:, -1:]
    check(not bool((diff & ~tail_tie).any()),
          "K-Q: positions differ from the plain version")
    full = p_k >= 0
    check(not bool(((alive[p_k.long().clamp(min=0)] <= 0) & full).any()),
          "K-Q: a dead row entered the shortlist")
    fin = torch.isfinite(lb_k)
    err = float((lb_k[fin] - lb_p[fin]).abs().max()) if bool(
        fin.any()) else 0.0
    ms = time_ms(lambda: kq.quant_coarse_gather_cuda(*args, bm=bm, bn=bn),
                 iters=20)
    plain_ms = time_ms(lambda: kq.quant_coarse_sched_plain(*args, bm=bm,
                                                           bn=bn),
                       warmup=1, iters=plain_iters)
    # work of these inputs: each live row of each visited tile against
    # the R tile's bm queries; each visited tile read once
    nr_tiles, ns_tiles = sched.shape[0], pl.sq.shape[0] // bn
    counts = cnt.long()
    slot = torch.arange(sched.shape[1], device=DEV)[None, :]
    visited = sched.long()[slot < counts[:, None]]
    live_per_tile = (alive.reshape(ns_tiles, bn) > 0).sum(1)
    pairs = float(bm * live_per_tile[visited].sum())
    tiles = torch.unique(visited)
    d = qi.shape[1]
    n_bytes = (qi.numel() + 12.0 * qi.shape[0]
               + tiles.numel() * (bn * (d + 2.0 + 4.0) + 4.0)
               + 4.0 * (int(counts.sum()) + nr_tiles)
               + 8.0 * qi.shape[0] * mp)
    int8_ops, f32_ops = pairs * 2 * d, pairs * 16
    b_ms, b_by = bound(n_bytes, f32_ops, int8_ops)
    frac = float(counts.sum()) / (nr_tiles * ns_tiles)
    print(f"[{card}] K-Q int8 coarse scan bucket={qi.shape[0]} d={d} mp={mp} "
          f"bm={bm} bn={bn}: visited-tile fraction {frac:.4f}, lb "
          f"bit-equal to the plain version, positions equal "
          f"{float((~diff).double().mean()):.6f} (rest ties at the run's "
          f"tail), kept slots {float(full.double().mean()):.4f}; kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms "
          f"({b_by}: {n_bytes:.4e} bytes, {int8_ops:.4e} int8 + "
          f"{f32_ops:.4e} fp32 operations = {pairs:.4e} pairs x (2d int8 "
          f"+ 16 fp32))", flush=True)
    return dict(name="quant_coarse_gather", route="cuda",
                source="src/repro_torch/csrc/quant_coarse.cu",
                replaces="src/repro/kernels/quant_topk.py:105",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None)


def check_exact(card, rt, what: str, r_np, s_np, d, i, k: int, *,
                n_sample: int = 2048, report: bool = True) -> None:
    """A join result against the float64 brute force on ``n_sample``
    sampled queries (all of them when fewer), tie-aware: distances
    within 4 ulp (equal bits expected: both report the canonical chain),
    every reported id's true distance within the true k-th, no
    duplicate ids."""
    import numpy as np
    check(d.shape == (r_np.shape[0], k) and bool(np.isfinite(d).all())
          and bool((i >= 0).all()), f"{what}: malformed result")
    n = r_np.shape[0]
    sample = np.random.default_rng(3).choice(n, min(n_sample, n),
                                             replace=False)
    bd, bi = rt.brute_force_knn(r_np[sample], s_np, k, device=DEV)
    got_d, got_i = d[sample], i[sample]
    ulp = np.spacing(np.maximum(bd, 1.0).astype(np.float32))
    check(bool((np.abs(got_d - bd) <= 4 * ulp).all()),
          f"{what}: reported distances off the brute force beyond 4 ulp")
    q64 = r_np[sample].astype(np.float64)
    s64 = s_np.astype(np.float64)
    true_d = np.sqrt(((q64[:, None, :] - s64[got_i]) ** 2).sum(-1))
    kth = np.sqrt(((q64[:, None, :] - s64[bi[:, -1:]]) ** 2).sum(-1))
    check(bool((true_d <= kth * (1 + 1e-6) + 1e-6).all()),
          f"{what}: a reported id lies beyond the true k-th distance")
    check(all(len(set(row)) == k for row in got_i.tolist()),
          f"{what}: duplicate ids in a row")
    if report:
        print(f"[{card}] {what} vs brute force (fp64) on {len(sample)} "
              f"queries: max |dist diff| "
              f"{float(np.abs(got_d - bd).max()):.3e}, ids equal "
              f"{float((got_i == bi).mean()):.6f} (rest exact ties)",
              flush=True)


def live_positions(what: str, gids, ids):
    """Global ids → positions in the ascending live-id table ``gids``;
    fails if an id is not live (dead, or never allocated)."""
    import numpy as np
    pos = np.clip(np.searchsorted(gids, ids), 0, gids.shape[0] - 1)
    check(bool((gids[pos] == ids).all()), f"{what}: an id is not live")
    return pos


def check_exact_live(card, rt, what: str, r_np, mi, d, i, k: int,
                     **kw):
    """:func:`check_exact` against the live rows of a ``MutableIndex``
    (global ids mapped to live-row positions). Returns (rows, gids)."""
    rows, gids = mi.live_rows()
    check_exact(card, rt, what, r_np, rows, d,
                live_positions(what, gids, i), k, **kw)
    return rows, gids


def check_same_distances(what: str, d, ref_d, i, ref_i) -> None:
    """Two routes' canonical distances bit for bit; ids may differ only
    where the distances tie."""
    import numpy as np
    check(np.array_equal(d, ref_d),
          f"{what}: distances not bitwise the reference route's")
    mism = i != ref_i
    check(np.array_equal(d[mism], ref_d[mism]),
          f"{what}: ids differ beyond ties")


def dense_case(card, torch, kd, what: str, q, s, k: int, mask, *,
               library: bool, bm: int = 128, bn: int = 512) -> dict:
    """K-D against its plain version on one shape; times both, and one
    ``torch.topk(torch.cdist(q, s))`` (two library calls, never used by
    the port) where no mask applies."""
    kw = dict(visit_mask=mask, bm=bm, bn=bn)
    d_k, p_k = kd.distance_topk_cuda(q, s, k, **kw)
    d_p, p_p = kd.distance_topk_plain(q, s, k, **kw)
    torch.cuda.synchronize()
    used, same, err, tol = check_runs(torch, f"K-D ({what})", q, s, d_k,
                                      p_k, d_p, p_p)
    ms = time_ms(lambda: kd.distance_topk_cuda(q, s, k, **kw), iters=10)
    plain_ms = time_ms(lambda: kd.distance_topk_plain(q, s, k, **kw),
                       warmup=1, iters=2)
    lib_ms = (time_ms(lambda: torch.topk(torch.cdist(q, s), k,
                                         largest=False),
                      warmup=1, iters=3) if library else None)
    # the work of these inputs: each (query, row) pair of a visited
    # (R tile, S tile); each input read once, each output written once
    n_r, d = q.shape
    n_s = s.shape[0]
    q_per = torch.full((-(-n_r // bm),), bm, dtype=torch.float64,
                       device=DEV)
    q_per[-1] = n_r - bm * (q_per.shape[0] - 1)
    s_per = torch.full((-(-n_s // bn),), bn, dtype=torch.float64,
                       device=DEV)
    s_per[-1] = n_s - bn * (s_per.shape[0] - 1)
    vis = (torch.ones((q_per.shape[0], s_per.shape[0]), dtype=torch.float64,
                      device=DEV) if mask is None else (mask != 0).double())
    pairs = float(q_per @ vis @ s_per)
    rows_read = float(s_per[vis.amax(0) > 0].sum())
    n_bytes = (4.0 * d * (n_r + rows_read) + 8.0 * n_r * k
               + (0 if mask is None else mask.numel()))
    b_ms, b_by = bound(n_bytes, pairs * (2 * d + 3))
    print(f"[{card}] K-D dense top-k ({what}) n_r={n_r} n_s={n_s} d={d} "
          f"k={k}" + ("" if mask is None else
                      f", visited-tile fraction {float(vis.mean()):.4f}")
          + f": ids equal {same:.6f} (rest near-ties), max |dist err| "
          f"{err:.3e}, max |d² err| {used:.3e} of its pair's tolerance "
          f"({tol_text(tol)}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"cdist+topk (two library calls) "
          + ("none (masked)" if lib_ms is None else f"{lib_ms:.4f} ms")
          + f", bound {b_ms:.4f} ms ({b_by}: {pairs:.4e} pairs x (2d+3) "
          f"fp32 operations, {n_bytes:.4e} bytes)", flush=True)
    return dict(shape=what, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)


def phase_dense(card, torch, rt, s_np, r_np) -> dict:
    """K-D vs its plain version: (a) the retrieval shape — 4,096
    queries over the 522,911 base rows, centered, d = 10, k = 10; (b)
    the same with a seeded 50 % visit mask; (c) a kNN-LM width — 256
    queries over 262,144 Gaussian keys of d = 1,024 (1 GiB), k = 8."""
    import numpy as np
    from repro_torch.kernels import distance_topk as kd
    base = torch.as_tensor(s_np[:N_BASE], device=DEV)
    center = base.double().mean(0).float()
    s_c = (base - center).contiguous()
    q_c = (torch.as_tensor(r_np[:BUCKET], device=DEV) - center).contiguous()
    a = dense_case(card, torch, kd, "a: retrieval shape", q_c, s_c, 10,
                   None, library=True)
    rng = np.random.default_rng(10)
    mask = torch.as_tensor(
        (rng.random((BUCKET // 128, -(-N_BASE // 512))) < 0.5)
        .astype(np.int8), device=DEV)
    b = dense_case(card, torch, kd, "b: 50 % visit mask", q_c, s_c, 10,
                   mask, library=False)
    del base, s_c
    g = torch.Generator(device=DEV).manual_seed(4)
    keys = torch.randn((LM_KEYS, LM_DIM), generator=g, device=DEV)
    qw = torch.randn((LM_QUERIES, LM_DIM), generator=g, device=DEV)
    c = dense_case(card, torch, kd, "c: kNN-LM width", qw, keys, 8, None,
                   library=True)
    del keys
    torch.cuda.empty_cache()
    row = dict(name="distance_topk", route="cuda",
               source="src/repro_torch/csrc/dense_topk.cu",
               replaces="src/repro/kernels/distance_topk.py:71")
    row.update({key: a[key] for key in ("max_abs_err", "ms", "plain_ms",
                                        "bound_ms", "bound_by",
                                        "library_ms")})
    row["other_shapes"] = [b, c]
    return row


def phase_mutable(card, torch, rt, s_np, r_np, cfg, launches,
                  out_dir: Path) -> None:
    """The mutable index at Forest scale: a base of 522,911 rows, the
    other 58,101 inserted in waves of 4,096 (14 sealed deltas and 757
    buffered rows: 16 segments), then stage A (48 seeded deletes, θ
    finite), stage B (5,810 in all, 1 %: θ = +inf) and stage C
    (``compact``). Each stage: the megastep join of all of R, exact
    against the float64 brute force over the live rows, bitwise equal
    to a megastep over a fresh ``build_index`` of the survivors, one
    K-G launch per batch; in stage A also the host route and the
    quantized route on ``HOST_ROWS`` queries, and one multi-segment
    ``join_batch_device`` under the sync debug mode."""
    import numpy as np
    from repro_torch.kernels import ops
    refreshes = rt.obs.metrics.REGISTRY.counter(
        "megastep_payload_refresh_total")

    def synced(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    mi, t_build = synced(lambda: rt.MutableIndex.build(
        s_np[:N_BASE], cfg, seal_threshold=BUCKET, device=DEV))
    eng = rt.MegastepEngine(mi, cfg, device=DEV)
    qd, nv = eng.enqueue(r_np[:BUCKET])
    steps = {"1 segment, 0 tombstones":
             time_ms(lambda: eng.join_batch_device(qd, nv), iters=10)}
    held = s_np[N_BASE:]
    _, t_insert = synced(lambda: [mi.insert(held[lo:lo + BUCKET])
                                  for lo in range(0, held.shape[0], BUCKET)])
    n_sealed, n_buf = divmod(held.shape[0], BUCKET)
    n_segs = 1 + n_sealed + (n_buf > 0)
    check(len(mi.segments) == 1 + n_sealed and mi.n_buffered == n_buf
          and mi.n_segments == n_segs,
          f"mutable index: expected {n_sealed} sealed deltas + {n_buf} "
          f"buffered rows, got {mi!r}")
    _, t_ref_struct = synced(eng.payload)
    steps[f"{n_segs} segments, 0 tombstones"] = time_ms(
        lambda: eng.join_batch_device(qd, nv), iters=10)
    print(f"[{card}] mutable index: build {t_build:.3f} s over {N_BASE} "
          f"rows; {held.shape[0]} rows inserted in {t_insert:.3f} s "
          f"({len(mi.segments) - 1} seals, {mi.n_buffered} buffered); "
          f"payload refresh after the inserts {t_ref_struct * 1e3:.3f} ms",
          flush=True)

    rng = np.random.default_rng(11)
    dead_a = rng.choice(N_ROWS, DEAD_A, replace=False)
    # stage B takes the PROBE_DEAD nearest rows of the first PROBES
    # queries with it, so the host route must re-fetch their segment at
    # k + (its tombstones) rows: over-fetch far past 64 in K-G
    _, near = rt.brute_force_knn(r_np[:PROBES], s_np, PROBE_DEAD, device=DEV)
    probe_ids = np.setdiff1d(np.unique(near), dead_a)
    dead_b = np.concatenate([probe_ids, rng.choice(
        np.setdiff1d(np.arange(N_ROWS), np.union1d(dead_a, probe_ids)),
        DEAD_TOTAL - DEAD_A - probe_ids.size, replace=False)])
    stages = (("A", lambda: mi.delete(dead_a), n_segs, DEAD_A),
              ("B", lambda: mi.delete(dead_b), n_segs, DEAD_TOTAL),
              ("C", mi.compact, 1, 0))
    for name, mutate, n_segs, n_dead in stages:
        _, t_mut = synced(mutate)
        before = refreshes.value
        _, t_refresh = synced(eng.payload)
        n_rebuilt = refreshes.value - before
        key = (f"{n_segs} segment{'s' * (n_segs > 1)}, {n_dead} tombstones"
               + (", compacted" if name == "C" else ""))
        steps[key] = time_ms(lambda: eng.join_batch_device(qd, nv), iters=10)
        ops.reset_launch_counts()
        res, t_join = synced(lambda: rt.knn_join_batched(
            r_np, index=mi, batch_size=BUCKET, megastep=True, device=DEV))
        counts = launches[f"mutable_{name}"] = ops.launch_counts()
        st = res.stats
        check(st.n_segments == n_segs and st.n_tombstones == n_dead
              and mi.n_tombstones == n_dead,
              f"stage {name}: {st.n_segments} segments / {st.n_tombstones} "
              f"tombstones, expected {n_segs} / {n_dead}")
        check(counts["distance_topk_gather"] == st.n_batches,
              f"stage {name}: K-G launched {counts['distance_topk_gather']} "
              f"times for {st.n_batches} batches")
        rows, gids = check_exact_live(card, rt, f"mutable megastep stage "
                                      f"{name}", r_np, mi, res.distances,
                                      res.indices, cfg.k)
        if name == "B":
            host_route_overfetch(card, rt, mi, cfg, r_np, res)
        fresh = rt.build_index(rows, cfg, device=DEV)
        ref = rt.knn_join_batched(r_np, index=fresh, batch_size=BUCKET,
                                  megastep=True, device=DEV)
        check_same_distances(f"stage {name}: mutable vs fresh index",
                             res.distances, ref.distances, res.indices,
                             gids[ref.indices])
        print(f"[{card}] stage {name} ({key}): mutation {t_mut:.3f} s"
              + (f" (compact {mi.last_compact_s:.3f} s)" if name == "C"
                 else "")
              + f", payload refresh {t_refresh * 1e3:.3f} ms "
              f"({n_rebuilt:.0f} rebuild), step "
              f"{steps[key]:.4f} ms, join {t_join:.3f} s over {N_ROWS} "
              f"queries = {N_ROWS / t_join:.1f} queries/s, {st.n_batches} "
              f"batches, launches {counts}; bitwise equal to a fresh index "
              f"of the {rows.shape[0]} survivors", flush=True)
        if name != "A":
            continue
        profile_device(card, torch, lambda: eng.join_batch_device(qd, nv),
                       f"steady-state megastep over {n_segs} segments, "
                       f"{n_dead} tombstones (per step, {BUCKET} queries)",
                       out_dir / "mutable_profile.txt", runs=5)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = eng.join_batch_device(qd, nv)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        check(torch.equal(out[0][:BUCKET].cpu(), torch.as_tensor(
            res.distances[:BUCKET])), "stage A: the steady step differs")
        r_h = r_np[:HOST_ROWS]
        cfg_h = dataclasses.replace(cfg, n_groups=8, reducer="gather")
        host, t_host = synced(lambda: rt.knn_join(r_h, index=mi,
                                                  config=cfg_h, device=DEV))
        check_same_distances("stage A: host route vs megastep",
                             host.distances, res.distances[:HOST_ROWS],
                             host.indices, res.indices[:HOST_ROWS])
        cfg_q = dataclasses.replace(cfg_h, quant_slack=118)
        quant, t_quant = synced(lambda: rt.knn_join_batched(
            r_h, index=mi, config=cfg_q, batch_size=BUCKET, quantized=True,
            device=DEV))
        check_same_distances("stage A: quantized route vs megastep",
                             quant.distances, res.distances[:HOST_ROWS],
                             quant.indices, res.indices[:HOST_ROWS])
        fb = quant.stats.n_quant_fallback
        print(f"[{card}] stage A: one {n_segs}-segment join_batch_device with "
              f"no host sync under set_sync_debug_mode('error'); host route "
              f"(gather reducer) over {HOST_ROWS} queries {t_host:.3f} s, "
              f"quantized route {t_quant:.3f} s (certification fallbacks "
              f"{fb} = {fb / HOST_ROWS:.4%}), both bitwise equal to the "
              f"megastep", flush=True)
    print(f"[{card}] mutable megastep step ms ({BUCKET}-query bucket): "
          + ", ".join(f"{k} {v:.4f}" for k, v in steps.items()), flush=True)


def host_route_overfetch(card, rt, mi, cfg, r_np, res) -> None:
    """Stage B's host route (gather reducer) over ``HOST_ROWS`` queries:
    the probe queries' segment is re-fetched at k + its tombstones, so K-G
    runs with k far past 64 (its general kernel); bitwise equal to the
    megastep."""
    from repro_torch.kernels import distance_topk as kg
    ks = []
    kernel = kg.distance_topk_gather_cuda

    def spy(r, s, k, *args, **kw):
        ks.append(k)
        return kernel(r, s, k, *args, **kw)

    cfg_h = dataclasses.replace(cfg, n_groups=8, reducer="gather")
    kg.distance_topk_gather_cuda = spy
    try:
        t0 = time.perf_counter()
        host = rt.knn_join(r_np[:HOST_ROWS], index=mi, config=cfg_h,
                           device=DEV)
        t_host = time.perf_counter() - t0
    finally:
        kg.distance_topk_gather_cuda = kernel
    check(bool(ks) and max(ks) > 64,
          f"stage B: the host route never asked K-G for more than 64 rows "
          f"(k = {sorted(set(ks))})")
    check_same_distances("stage B: host route vs megastep", host.distances,
                         res.distances[:HOST_ROWS], host.indices,
                         res.indices[:HOST_ROWS])
    print(f"[{card}] stage B: host route (gather reducer) over {HOST_ROWS} "
          f"queries {t_host:.3f} s, K-G asked for k in {sorted(set(ks))} "
          f"(the over-fetch of the {PROBES} probe queries' segment), "
          f"bitwise equal to the megastep", flush=True)


def phase_retrieval(card, torch, rt, s_np, r_np, launches) -> None:
    """kNN-LM retrieval over a ``Datastore`` of the 522,911 base rows
    (values: seeded labels 0..6): 16 decode steps of 4,096 queries,
    each through both ``knn_logits`` routes; between steps 1,024
    held-out rows are added and 16 seeded live ids removed, and the
    store is compacted after step 8."""
    import numpy as np
    from repro_torch.kernels import ops
    from repro_torch.serve import Datastore, KnnLMConfig, knn_logits
    vocab, k, n_steps = 7, 10, DECODE_STEPS
    labels = np.random.default_rng(12).integers(0, vocab, N_ROWS) \
        .astype(np.int32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    store = Datastore.build(s_np[:N_BASE], labels[:N_BASE], k=k,
                            n_pivots=256, device=DEV)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    d0, _, _ = store.retrieve(r_np[:BUCKET], k)
    tau = float(np.median(d0[:, -1].astype(np.float64) ** 2))
    kcfg = KnnLMConfig(k=k, tau=tau)
    print(f"[{card}] retrieval: Datastore.build {t_build:.3f} s over "
          f"{N_BASE} keys; tau = median k-th d² of step 0 = {tau:.6g}",
          flush=True)
    rng = np.random.default_rng(13)
    next_add = N_BASE
    ms = {"join": [], "kernel": []}
    n_lp, n_swapped, lp_used = 0, 0, 0.0
    ops.reset_launch_counts()
    for step in range(n_steps):
        q = r_np[step * BUCKET:(step + 1) * BUCKET]
        out = {}
        for route, use_kernel in (("join", False), ("kernel", True)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out[route] = knn_logits(q, store, kcfg, vocab,
                                    use_kernel=use_kernel,
                                    return_neighbors=True)
            torch.cuda.synchronize()
            ms[route].append((time.perf_counter() - t0) * 1e3)
        lg_j, (d_j, i_j) = out["join"]
        lg_k, (d_k, i_k) = out["kernel"]
        what = f"retrieval step {step}"
        rows, gids = check_exact_live(card, rt, f"{what} join route", q,
                                      store.index, d_j, i_j, k,
                                      n_sample=256, report=False)
        # the routes against each other, on the rows K-D saw (centered)
        rows_c, center, _ = store.index.live_device_centered()
        q_c = torch.as_tensor(q, device=DEV) - center
        _, _, _, tol = check_runs(
            torch, f"{what}: kernel route vs join route", q_c, rows_c,
            torch.as_tensor(d_k, device=DEV),
            torch.as_tensor(live_positions(what, gids, i_k), device=DEV),
            torch.as_tensor(d_j, device=DEV),
            torch.as_tensor(live_positions(what, gids, i_j), device=DEV))
        # log-probs: a d² moved by at most δ moves each softmax logit by
        # δ/τ and a log-probability by at most 2·max δ/τ; allow 2·δ per
        # id (each route off the exact d² by up to the limit) plus 2⁻¹⁵
        # for float32 rounding of d², exp, the sums and log over the
        # range the 1e-9 floor leaves. Rows whose id sets differ (ties
        # at the k-th distance, checked above) are left out and counted.
        lp_tol = 4.0 * float(tol.max()) / tau + 2.0 ** -15
        same_set = (np.sort(i_j, axis=1) == np.sort(i_k, axis=1)).all(1)
        diff = (float(np.abs(lg_j[same_set] - lg_k[same_set]).max())
                if same_set.any() else 0.0)
        check(diff <= lp_tol, f"{what}: log-probs differ by {diff:.3e} > "
              f"{lp_tol:.3e}")
        n_lp += int(same_set.sum())
        n_swapped += int((~same_set).sum())
        lp_used = max(lp_used, diff / lp_tol)
        if step == n_steps - 1:
            break
        ids = store.add_entries(s_np[next_add:next_add + ADD_ROWS],
                                labels[next_add:next_add + ADD_ROWS])
        next_add += ADD_ROWS
        tomb = set(store.index.tombstones_sorted().tolist())
        live = np.setdiff1d(np.arange(int(ids[-1]) + 1),
                            np.fromiter(tomb, np.int64, len(tomb)))
        store.remove_entries(rng.choice(live, REMOVE_IDS, replace=False))
        if step == 8:
            store.compact()
            print(f"[{card}] retrieval: compact after step 8 took "
                  f"{store.index.last_compact_s:.3f} s", flush=True)
    counts = launches["retrieval"] = ops.launch_counts()
    check(counts["distance_topk"] == n_steps
          and counts["distance_topk_gather"] >= n_steps,
          f"retrieval: expected {n_steps} K-D launches and at least as "
          f"many K-G launches, got {counts}")
    print(f"[{card}] retrieval: {n_steps} decode steps x {BUCKET} queries, "
          f"vocab {vocab}; join route exact vs fp64 brute force (256 "
          f"sampled queries a step), routes' distances within the pair "
          f"limit; log-probs agree on {n_lp} rows (max {lp_used:.3e} of the "
          f"limit 4·max δ/τ + 2^-15), {n_swapped} rows with tie-swapped "
          f"ids; launches {counts}", flush=True)
    for route in ("join", "kernel"):
        print(f"[{card}] retrieval {route} route ms per step (refresh "
              f"included): " + ", ".join(f"{x:.3f}" for x in ms[route]),
              flush=True)


_ROW_KEYS = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms")


def attention_err(torch, out, ref) -> tuple[float, float]:
    """K-F's output against its plain version's: (max |err|, the share
    of the limit used). Both compute in float32 and round once to the
    output type, in another order of sums: float32 outputs agree within
    2e-5 abs, bfloat16 ones within one bf16 rounding (2⁻⁷ of the larger
    magnitude) plus 1e-6."""
    a, b = out.float(), ref.float()
    diff = (a - b).abs()
    if out.dtype == torch.bfloat16:
        lim = 2.0 ** -7 * torch.maximum(a.abs(), b.abs()) + 1e-6
    else:
        lim = torch.full_like(a, 2e-5)
    return float(diff.max()), float((diff / lim).max())


def attention_case(card, torch, what: str, q, k, v, *, window=None,
                   library=None) -> dict:
    """K-F vs its plain version on one shape (causal, queries
    right-aligned), both timed, with ``library`` (one PyTorch call of the
    same function) timed beside them; the bound is the larger of the
    bytes of q, k, v and o at the HBM rate and the visible pairs'
    4·d operations at the bf16 tensor-core peak."""
    from repro_torch.kernels import flash_attention as kf
    b, nq, h, d = q.shape
    nk, kvh = k.shape[1], k.shape[2]
    out = kf.flash_attention_cuda(q, k, v, window=window)
    plan = kf.last_plan
    ref = kf.flash_attention_plain(q, k, v, window=window)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(out.float()).all()),
          f"K-F ({what}): non-finite output")
    err, used = attention_err(torch, out, ref)
    check(used <= 1.0, f"K-F ({what}): {used:.3f} of the limit against the "
          f"plain version")
    del ref
    ms = time_ms(lambda: kf.flash_attention_cuda(q, k, v, window=window),
                 iters=10)
    plain_ms = time_ms(lambda: kf.flash_attention_plain(q, k, v,
                                                        window=window),
                       warmup=1, iters=2)
    lib_ms = None if library is None else time_ms(library, iters=10)
    pos = torch.arange(nq, device=DEV, dtype=torch.float64) + (nk - nq)
    lo = torch.zeros_like(pos) if window is None else \
        torch.clamp(pos - window + 1, min=0)
    pairs = float(b * h * torch.clamp(torch.minimum(pos, torch.full_like(
        pos, nk - 1)) - lo + 1, min=0).sum())
    n_bytes = float(q.element_size()) * (2 * q.numel() + k.numel()
                                         + v.numel())
    t_b = n_bytes / H100_HBM_BYTES_S * 1e3
    t_f = 4.0 * d * pairs / H100_BF16_FLOPS_S * 1e3
    b_ms, b_by = (t_b, "bytes") if t_b >= t_f else (t_f, "operations")
    # the tensor-core form does 2d operations per pair for q·k and 3 x 2d
    # for the exact p·v (p split in three bf16 terms): its own floor
    floor_ms = (max(t_b, 2.0 * t_f) if plan.route == "mma" else b_ms)
    print(f"[{card}] K-F flash attention ({what}) q {tuple(q.shape)} kv "
          f"{tuple(k.shape)} {str(q.dtype).removeprefix('torch.')}"
          + ("" if window is None else f" window {window}")
          + f", route {plan.route} (width {plan.width}, {plan.zc} column "
          f"chunks, {plan.splits} key splits of {plan.split_keys}): max "
          f"|err| {err:.3e} ({used:.3f} of the limit) vs the plain "
          f"version; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          + ("" if lib_ms is None else f"SDPA {lib_ms:.4f} ms, ")
          + f"bound {b_ms:.4f} ms ({b_by}: {pairs:.4e} visible pairs x 4d "
          f"bf16 operations, {n_bytes:.4e} bytes), this design's floor "
          f"{floor_ms:.4f} ms", flush=True)
    return dict(shape=what, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                form=plan.route, splits=plan.splits)


def check_retrieval(card, torch, what: str, queries, keys64, kn64, d, ids,
                    k: int) -> None:
    """One retrieval against the float64 brute force over the live keys
    (on the card): distances within 4 ulp, every reported id's true
    distance within the true k-th, no duplicate ids."""
    import numpy as np
    q = torch.as_tensor(queries, device=DEV).double()
    d2 = torch.clamp((q * q).sum(1)[:, None] + kn64[None, :]
                     - 2.0 * (q @ keys64.T), min=0.0)
    bd2, _ = torch.topk(d2, k, dim=1, largest=False)
    bd = torch.sqrt(bd2).cpu().numpy()
    check(d.shape == (q.shape[0], k) and bool((ids >= 0).all()),
          f"{what}: malformed result")
    ulp = np.spacing(np.maximum(bd, 1.0).astype(np.float32))
    check(bool((np.abs(d - bd) <= 4 * ulp).all()),
          f"{what}: distances off the float64 brute force beyond 4 ulp")
    got = torch.gather(d2, 1, torch.as_tensor(ids, device=DEV).long())
    check(bool((got <= bd2[:, -1:] * (1 + 1e-6) + 1e-6).all()),
          f"{what}: a reported id lies beyond the true k-th distance")
    check(all(len(set(row)) == k for row in ids.tolist()),
          f"{what}: duplicate ids")


def tensor_core_instructions(card, name: str) -> int:
    """Tensor-core instructions (HGMMA, HMMA) in the SASS of one built
    kernel library (``cuobjdump -sass``); fails if there are none."""
    import os
    import re
    import shutil
    from repro_torch.kernels import build
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    check(os.path.exists(tool), "cuobjdump not found: cannot read K-F's SASS")
    sass = subprocess.run([tool, "-sass", str(build.library_path(name))],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    found = re.findall(r"\b(?:HGMMA|HMMA)\.[\w.]+", sass)
    check(len(found) > 0, f"{name}: no tensor-core instruction in its SASS")
    print(f"[{card}] {name} SASS: {len(found)} tensor-core instructions "
          f"({', '.join(sorted(set(found)))})", flush=True)
    return len(found)


def phase_lm(card, torch, rt, launches, out_dir: Path) -> dict:
    """14. The LM serving path at full width: llama3.2-3b in bf16 with
    seeded random weights, ``BatchedServer`` + ``make_knn_hook`` over a
    ``Datastore`` of 1,048,576 Gaussian keys. (a) K-F vs its plain version
    at the path's prefill and decode shapes and with a window, SDPA timed
    beside it; (b) 16 requests of 512-2,048 tokens, batch 8, 32 greedy
    tokens, counted (K-F once per layer per forward), every retrieval
    exact, every layer's K-F output of one prefill and one decode step
    held against the plain version, decode timed with and without the
    hook, and the device's busy share over decode steps with the hook
    profiled; (c) the reduced model on the card and on the CPU with the
    same weights: logits within tolerance, tokens equal."""
    import numpy as np
    import torch.nn.functional as F
    from repro_torch import configs
    from repro_torch.kernels import distance_topk as kg
    from repro_torch.kernels import flash_attention as kf
    from repro_torch.kernels import ops
    from repro_torch.models import (ModelOptions, count_params, forward,
                                    init_cache, init_params)
    from repro_torch.serve import (BatchedServer, Datastore, KnnLMConfig,
                                   ServeConfig, make_knn_hook,
                                   make_serve_step)
    cfg = configs.get_arch(LM_ARCH)
    h, kvh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.dh

    # ---- (a) K-F at the path's shapes
    gen = torch.Generator(device=DEV).manual_seed(14)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=DEV).to(torch.bfloat16)

    n = LM_PROMPT[1]
    q, k, v = rand(LM_BATCH, n, h, dh), rand(LM_BATCH, n, kvh, dh), \
        rand(LM_BATCH, n, kvh, dh)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    prefill = attention_case(
        card, torch, f"prefill b={LM_BATCH} nq=nk={n}", q, k, v,
        library=lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True))
    pos = torch.arange(n, device=DEV)
    wmask = ((pos[None, :] <= pos[:, None])
             & (pos[None, :] > pos[:, None] - 256))
    windowed = attention_case(
        card, torch, f"prefill b={LM_BATCH} nq=nk={n}, window 256", q, k, v,
        window=256, library=lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=wmask, enable_gqa=True))
    nk = n + LM_NEW
    kc, vc = rand(LM_BATCH, nk + 64, kvh, dh), rand(LM_BATCH, nk + 64, kvh, dh)
    q1 = rand(LM_BATCH, 1, h, dh)
    k1, v1 = kc[:, :nk], vc[:, :nk]          # a live slice of a cache
    q1t, k1t, v1t = (x.transpose(1, 2) for x in (q1, k1, v1))
    decode = attention_case(
        card, torch, f"decode b={LM_BATCH} nq=1 nk={nk}", q1, k1, v1,
        library=lambda: F.scaled_dot_product_attention(
            q1t, k1t, v1t, enable_gqa=True))
    del q, k, v, qt, kt, vt, kc, vc, q1, k1, v1, q1t, k1t, v1t, wmask
    # a head width no kernel is instantiated for (MLA's q·k width)
    q, k, v = rand(2, n, h, 192), rand(2, n, kvh, 192), rand(2, n, kvh, 192)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    wide = attention_case(
        card, torch, f"prefill b=2 nq=nk={n}, d=192", q, k, v,
        library=lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True))
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    n_mma = tensor_core_instructions(card, "flash_attn")

    # ---- (b) BatchedServer + the kNN-LM hook, counted
    opts = ModelOptions(dtype=torch.bfloat16)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=DEV).manual_seed(0),
                         opts, device=DEV)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_params = count_params(params)
    rng = np.random.default_rng(14)
    keys = rng.standard_normal((LM_STORE_KEYS, LM_STORE_DIM),
                               dtype=np.float32)
    vals = rng.integers(0, cfg.vocab, LM_STORE_KEYS).astype(np.int32)
    prompts = [rng.integers(0, cfg.vocab, int(rng.integers(
        LM_PROMPT[0], LM_PROMPT[1] + 1))).astype(np.int32)
        for _ in range(LM_REQUESTS)]
    kcfg = KnnLMConfig(lam=0.2, tau=50.0, k=8)
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    store = Datastore.build(keys, vals, k=8, n_pivots=128, n_groups=8,
                            device=DEV)
    torch.cuda.synchronize()
    t_store = time.perf_counter() - t0
    retrieved = []
    retrieve = store.retrieve

    def recording_retrieve(queries, k=None, **kw):
        d, ids, values = retrieve(queries, k, **kw)
        retrieved.append((np.array(queries), d, ids))
        return d, ids, values

    store.retrieve = recording_retrieve
    hook = make_knn_hook(store, kcfg, cfg.vocab)

    def timed(fn, into):
        def run(*args):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            into.append((time.perf_counter() - t) * 1e3)
            return out
        return run

    prefill_ms, decode_ms, hook_ms = [], [], []
    srv = BatchedServer(cfg, ServeConfig(batch=LM_BATCH), params, opts,
                        logits_hook=timed(hook, hook_ms))
    srv.prefill_step = timed(srv.prefill_step, prefill_ms)
    srv.decode_step = timed(srv.decode_step, decode_ms)
    t0 = time.perf_counter()
    outs = srv.generate(prompts, max_new_tokens=LM_NEW)
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    counts = launches["lm_serve"] = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    waves = -(-LM_REQUESTS // LM_BATCH)
    want_fa = cfg.n_layers * waves * (LM_NEW + 1)
    check(counts["flash_attention"] == want_fa,
          f"LM serving: K-F launched {counts['flash_attention']} times, "
          f"expected {cfg.n_layers} layers x {waves} waves x {LM_NEW + 1} "
          f"forwards = {want_fa}")
    check(counts["distance_topk_gather"] >= waves * LM_NEW
          and counts["assign"] > 0,
          f"LM serving: K-G must launch once a decode step at least and K-A "
          f"in the Datastore build: {counts}")
    check(len(outs) == LM_REQUESTS and all(
        o.shape == (LM_NEW,) and ((o >= 0) & (o < cfg.vocab)).all()
        for o in outs), "LM serving: malformed generations")
    check(len(retrieved) == waves * LM_NEW,
          f"LM serving: {len(retrieved)} retrievals for "
          f"{waves * LM_NEW} decode steps")
    keys64 = torch.as_tensor(keys, device=DEV).double()
    kn64 = (keys64 * keys64).sum(1)
    for i, (qr, d, ids) in enumerate(retrieved):
        check_retrieval(card, torch, f"decode step {i} retrieval", qr, keys64,
                        kn64, d, ids, kcfg.k)
    del keys64, kn64
    n_tok = LM_REQUESTS * LM_NEW
    print(f"[{card}] LM serving {LM_ARCH} (bf16, {n_params} parameters, "
          f"init {t_init:.3f} s): Datastore.build {t_store:.3f} s over "
          f"{LM_STORE_KEYS} keys x {LM_STORE_DIM}; {LM_REQUESTS} requests of "
          f"{min(map(len, prompts))}-{max(map(len, prompts))} prompt tokens, "
          f"batch {LM_BATCH}, {LM_NEW} greedy tokens each in {t_gen:.3f} s "
          f"= {n_tok / t_gen:.1f} tokens/s with the kNN-LM hook; peak memory "
          f"{peak / 2 ** 30:.3f} GiB; launches {counts}; every retrieval "
          f"({len(retrieved)}) exact vs the float64 brute force", flush=True)
    print(f"[{card}] LM serving prefill ms per wave: "
          + ", ".join(f"{x:.3f}" for x in prefill_ms), flush=True)
    print(f"[{card}] LM serving decode ms per step (model only; median "
          f"{float(np.median(decode_ms)):.3f}): "
          + ", ".join(f"{x:.3f}" for x in decode_ms), flush=True)
    print(f"[{card}] LM serving kNN-LM hook ms per step (median "
          f"{float(np.median(hook_ms)):.3f}): "
          + ", ".join(f"{x:.3f}" for x in hook_ms), flush=True)

    # K-G alone at one decode step's retrieval (8 queries, 1M keys)
    seen = {}
    kernel = kg.distance_topk_gather_cuda

    def grab(r, s, k, schedule, counts, **kw):
        seen.update(r=r, s=s, k=k, schedule=schedule, counts=counts, **kw)
        return kernel(r, s, k, schedule, counts, **kw)

    kg.distance_topk_gather_cuda = grab
    try:
        store.retrieve(retrieved[0][0], kcfg.k)
    finally:
        kg.distance_topk_gather_cuda = kernel
    alive = seen.get("alive")
    g = dict(qcs=seen["r"], s_c=seen["s"], sched=seen["schedule"],
             cnt=seen["counts"], bm=seen["bm"], bn=seen["bn"],
             alive=torch.ones(seen["s"].shape[0], device=DEV)
             if alive is None else alive)
    kg_decode = gather_case(card, torch, f"kNN-LM decode step: "
                            f"{retrieved[0][0].shape[0]} queries over "
                            f"{LM_STORE_KEYS} keys", g, seen["k"],
                            plain_iters=1)
    del g, seen

    # every layer's K-F output of one prefill and one decode step vs plain
    errs = []
    flash = ops.flash_attention

    def checking(q, k, v, **kw):
        out = flash(q, k, v, **kw)
        errs.append(attention_err(torch, out, kf.flash_attention_plain(
            q, k, v, **kw)))
        return out

    prefill_step, decode_step = make_serve_step(cfg, ServeConfig(), opts)
    wave = prompts[:LM_BATCH]
    tmax = max(len(p) for p in wave)
    pad = np.zeros((len(wave), tmax), np.int32)
    for r, p in enumerate(wave):
        pad[r, tmax - len(p):] = p
    ops.flash_attention = checking
    try:
        cache = init_cache(cfg, len(wave), tmax + 8, opts, device=DEV)
        logits, cache = prefill_step(params, torch.as_tensor(pad, device=DEV),
                                     cache)
        tok = torch.argmax(logits, -1).to(torch.int32)
        logits, cache = decode_step(params, tok[:, None], cache)
    finally:
        ops.flash_attention = flash
    torch.cuda.synchronize()
    check(len(errs) == 2 * cfg.n_layers,
          f"layer check: {len(errs)} K-F calls, expected {2 * cfg.n_layers}")
    worst = max(u for _, u in errs)
    check(worst <= 1.0, f"layer check: a layer's K-F output is {worst:.3f} "
          f"of the limit off its plain version")
    print(f"[{card}] LM serving layer check: all {cfg.n_layers} layers' K-F "
          f"outputs of one prefill (b={len(wave)}, {tmax} tokens) and one "
          f"decode step vs the plain version on the same q/k/v: max |err| "
          f"{max(e for e, _ in errs):.3e}, {worst:.3f} of the bf16 limit",
          flush=True)
    state = {"logits": logits}

    def step():     # one decode step of the served loop: hook, sample, decode
        tok = torch.argmax(hook(state["logits"], cache), -1).to(torch.int32)
        state["logits"], _ = decode_step(params, tok[:, None], cache)

    profile_device(card, torch, step, f"LM decode step with the kNN-LM hook "
                   f"(b={len(wave)}, cache {tmax + 1}+)",
                   out_dir / "lm_decode_profile.txt", runs=4)
    del cache, logits, state
    plain_ms = []
    srv0 = BatchedServer(cfg, ServeConfig(batch=LM_BATCH), params, opts)
    srv0.decode_step = timed(srv0.decode_step, plain_ms)
    srv0.generate(prompts[:LM_BATCH], max_new_tokens=LM_NEW)
    print(f"[{card}] LM serving decode ms per step without the hook (one "
          f"wave; median {float(np.median(plain_ms)):.3f}): "
          + ", ".join(f"{x:.3f}" for x in plain_ms), flush=True)
    del params, srv, srv0, store
    torch.cuda.empty_cache()

    # ---- (c) the reduced model: card vs CPU, the same weights
    cfg_r = configs.get_reduced(LM_ARCH)
    opts32 = ModelOptions(dtype=torch.float32)
    cpu_params = init_params(cfg_r, torch.Generator().manual_seed(2), opts32,
                             device="cpu")

    def to_dev(tree):
        if isinstance(tree, dict):
            return {key: to_dev(val) for key, val in tree.items()}
        if isinstance(tree, list):
            return [to_dev(val) for val in tree]
        return tree.to(DEV)

    dev_params = to_dev(cpu_params)
    toks = torch.as_tensor(rng.integers(0, cfg_r.vocab, (4, 300)))
    lg_cpu, _ = forward(cpu_params, cfg_r, toks, opts=opts32)
    lg_dev, _ = forward(dev_params, cfg_r, toks.to(DEV), opts=opts32)
    again, _ = forward(dev_params, cfg_r, toks.to(DEV), opts=opts32)
    check(torch.equal(lg_dev, again),
          "reduced model: two identical forwards on the card differ")
    del again
    ops.flash_attention = kf.flash_attention_plain
    try:
        lg_dev_plain, _ = forward(dev_params, cfg_r, toks.to(DEV), opts=opts32)
    finally:
        ops.flash_attention = flash
    lg_dev, lg_dev_plain = lg_dev.cpu(), lg_dev_plain.cpu()
    # K-F's share: the card's logits with K-F and with the plain attention
    # on the card, both fp32 (the fp32 limit of attention_err, 2e-5, per
    # unit of logit)
    kf_diff = float((lg_dev - lg_dev_plain).abs().max())
    check(bool(((lg_dev - lg_dev_plain).abs()
                <= 2e-5 + 2e-5 * lg_dev_plain.abs()).all()),
          f"reduced model: K-F moves the card's logits by {kf_diff:.3e}")
    # card vs CPU: the same fp32 function on both devices. The RoPE
    # tables (frequencies, cos, sin) are taken in float64 and rounded once,
    # so both devices hold the same float32 tables; what is left is each
    # device's order of sums and its float32 exp / rsqrt / silu, within
    # 2e-5 + 2e-5·|logit|.
    from repro_torch.models.layers import rope_tables
    tables = []
    for where in ("cpu", DEV):
        pos = torch.arange(300, device=where)[None, :]
        tables.append(torch.cat(rope_tables(pos, cfg_r.dh // 2,
                                            cfg_r.rope_theta)).cpu())
    table_diff = float((tables[0] - tables[1]).abs().max())
    diff = float((lg_dev - lg_cpu).abs().max())
    plain_diff = float((lg_dev_plain - lg_cpu).abs().max())
    isa = f"{torch.backends.cpu.get_cpu_capability()}, {cpu_line()}"
    check(table_diff == 0.0, f"reduced model: RoPE tables differ card vs CPU "
          f"({isa}) by {table_diff:.3e}")
    check(bool(((lg_dev - lg_cpu).abs() <= 2e-5 + 2e-5 * lg_cpu.abs()).all()),
          f"reduced model: card logits off the CPU's by {diff:.3e}, past "
          f"2e-5 + 2e-5·|logit| (with the plain attention on the card "
          f"{plain_diff:.3e}; K-F vs the plain attention on the card "
          f"{kf_diff:.3e}; CPU {isa})")
    small = [rng.integers(0, cfg_r.vocab, int(n)).astype(np.int32)
             for n in (5, 130, 3, 260, 40)]
    got = {}
    for where, p in (("cpu", cpu_params), ("card", dev_params)):
        got[where] = BatchedServer(cfg_r, ServeConfig(batch=2), p,
                                   opts32).generate(small, max_new_tokens=8)
    check(all(np.array_equal(a, b) for a, b in zip(got["cpu"], got["card"])),
          "reduced model: greedy tokens differ between card and CPU")
    print(f"[{card}] reduced {LM_ARCH} (fp32, {count_params(cpu_params)} "
          f"parameters): card vs CPU logits over 4 x 300 tokens max |diff| "
          f"{diff:.3e} (limit 2e-5 + 2e-5·|logit|; with the plain attention "
          f"on the card {plain_diff:.3e}; RoPE cos/sin tables card vs CPU "
          f"({isa}) bitwise equal), K-F vs the plain attention on the "
          f"card {kf_diff:.3e} (limit 2e-5 + 2e-5·|logit|); a repeated "
          f"forward on the card bitwise equal; greedy tokens of 5 requests "
          f"(batch 2, 8 tokens) equal", flush=True)

    row = dict(name="flash_attention", route="cuda",
               source="src/repro_torch/csrc/flash_attn.cu",
               replaces="src/repro/kernels/flash_attention.py:27")
    row.update({key: prefill[key] for key in _ROW_KEYS})
    row["other_shapes"] = [decode, windowed, wide]
    row["tensor_core_instructions"] = n_mma
    row["lm_serve"] = dict(
        tokens_per_s=n_tok / t_gen, prefill_ms=prefill_ms,
        decode_ms_median=float(np.median(decode_ms)),
        hook_ms_median=float(np.median(hook_ms)),
        decode_ms_median_no_hook=float(np.median(plain_ms)),
        peak_bytes=peak, kg_decode_step=kg_decode)
    return row


def phase_caps(card, torch, rt, s_np, r_np, cfg, g_forest) -> dict:
    """13. The shapes the kernels refused before: K-A at d = 3,072, K-G at
    d = 256 / 1,024 and at k = 100 / 1,024, K-D at k = 128, K-Q at d =
    256 and at mp = 1,024 — each against its plain version, as its own
    phase checks it; and K-G's widest register form (d = 128, k = 64).
    Returns the cases per kernel."""
    import numpy as np
    from repro_torch.kernels import distance_topk as kd
    caps = {"assign": [], "distance_topk_gather": [], "distance_topk": [],
            "quant_coarse_gather": []}
    gen = torch.Generator(device=DEV).manual_seed(13)
    x = torch.randn((CAP_ROWS, 3072), generator=gen, device=DEV)
    piv = torch.randn((256, 3072), generator=gen, device=DEV)
    a = phase_assign(card, torch, rt, x, piv)
    caps["assign"].append(dict(
        shape=f"d = 3,072: {CAP_ROWS} Gaussian rows x 256 pivots",
        **{k: a[k] for k in _ROW_KEYS}))
    del x, piv
    rng = np.random.default_rng(13)
    cfg_g = rt.JoinConfig(k=10, n_pivots=256, tile_r=128, tile_s=512)
    for d, k in ((128, 64), (256, 10), (1024, 10)):
        s_g = rng.standard_normal((CAP_ROWS, d), dtype=np.float32)
        r_g = rng.standard_normal((BUCKET, d), dtype=np.float32)
        g = gather_inputs(torch, rt, s_g, r_g, cfg_g)
        caps["distance_topk_gather"].append(gather_case(
            card, torch, f"d = {d}, k = {k}, {CAP_ROWS} Gaussian rows", g, k))
        del g
        torch.cuda.empty_cache()
    for k in (100, 1024):
        caps["distance_topk_gather"].append(gather_case(
            card, torch, f"Forest bucket, k = {k}", g_forest, k,
            plain_iters=1))
    base = torch.as_tensor(s_np[:N_BASE], device=DEV)
    center = base.double().mean(0).float()
    s_c = (base - center).contiguous()
    q_c = (torch.as_tensor(r_np[:BUCKET], device=DEV) - center).contiguous()
    caps["distance_topk"].append(dense_case(
        card, torch, kd, "a: retrieval shape, k = 128", q_c, s_c, 128, None,
        library=True))
    del base, s_c, q_c
    s_q = rng.standard_normal((CAP_ROWS, 256), dtype=np.float32)
    r_q = rng.standard_normal((BUCKET, 256), dtype=np.float32)
    cfg_q = dataclasses.replace(cfg_g, quant_slack=118, reducer="gather")
    row = phase_quant(card, torch, rt,
                      rt.build_index(s_q, cfg_q, quantize="int8", device=DEV),
                      r_q, cfg_q, plain_iters=1)
    caps["quant_coarse_gather"].append(dict(
        shape=f"d = 256, {CAP_ROWS} Gaussian rows, mp = 128",
        **{k: row[k] for k in _ROW_KEYS}))
    cfg_m = dataclasses.replace(cfg, quant_slack=1014, reducer="gather")
    row = phase_quant(card, torch, rt,
                      rt.build_index(s_np, cfg_m, quantize="int8", device=DEV),
                      r_np, cfg_m, plain_iters=1)
    caps["quant_coarse_gather"].append(dict(
        shape="Forest bucket, mp = 1,024", **{k: row[k] for k in _ROW_KEYS}))
    torch.cuda.empty_cache()
    return caps


def profile_device(card, torch, fn, what: str, out_file: Path,
                   runs: int = 1) -> None:
    """Device time by kernel over ``runs`` calls of ``fn`` (torch.profiler),
    and the device's busy share of the same window's CUDA-event time.
    The profiler's host overhead lengthens the window, so the busy share
    is a lower bound. A profiler that records no device time on this
    machine is reported as not measured; an error in ``fn`` fails the
    run."""
    from torch.profiler import ProfilerActivity, profile
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(runs):
            fn()
        end.record()
        torch.cuda.synchronize()
    wall = start.elapsed_time(end) / runs
    kernels = [(e.key, e.self_device_time_total / 1e3 / runs)
               for e in prof.key_averages()
               if e.device_type.name == "CUDA" and e.self_device_time_total > 0]
    busy = sum(ms for _, ms in kernels)
    if not busy:
        print(f"[{card}] {what} profile: not measured (no device time "
              f"recorded)", flush=True)
        return
    kernels.sort(key=lambda kv: -kv[1])
    out_file.write_text(
        "".join(f"{ms:10.4f} ms  {name}\n" for name, ms in kernels))
    top = ", ".join(f"{name[:48]} {ms / busy:.1%}" for name, ms in kernels[:3])
    print(f"[{card}] {what} profile: {len(kernels)} kernels, device busy "
          f"{busy:.4f} ms of {wall:.4f} ms under the profiler "
          f"({busy / wall:.1%}); top: {top}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(ROOT / "build" / "chip_smoke"),
                    help="directory for long reports (ptxas output)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SmokeFailure("no CUDA device available")
    if not (ROOT / "src" / "repro_torch" / "__init__.py").is_file():
        raise SmokeFailure(f"the port's package is not beside this script "
                           f"({ROOT / 'src' / 'repro_torch'}): run it from "
                           f"a checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch as rt
    from repro_torch.kernels import build, ops

    # the plain versions' matrix products in full fp32, stated explicitly
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 1. card, versions, build
    card = card_line()
    print(f"[{card}] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.perf_counter()
    reports = build.build()
    build_s = time.perf_counter() - t0
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "ptxas.txt").write_text(
        "".join(f"== {n}\n{r}\n" for n, r in reports.items()))
    print(f"[{card}] built {sorted(reports) or 'nothing (cached)'} in "
          f"{build_s:.2f} s (ptxas report: {out_dir / 'ptxas.txt'})",
          flush=True)

    cfg = rt.JoinConfig(k=10, n_pivots=256, tile_r=128, tile_s=512)
    s_np = rt.forest_like(N_ROWS, DIM, seed=0)
    r_np = rt.forest_like(N_ROWS, DIM, seed=1)

    # ---- 2, 3. each kernel against its plain version
    s_dev = torch.as_tensor(s_np, device=DEV)
    pivots = torch.as_tensor(rt.core.select_pivots(
        s_np, cfg.n_pivots, cfg.pivot_strategy, sample=cfg.pivot_sample,
        n_sets=cfg.pivot_candidate_sets, seed=cfg.seed, device=DEV),
        device=DEV)
    g_row, g_forest = phase_gather(card, torch, rt, s_np, r_np, cfg)
    rows = [phase_assign(card, torch, rt, s_dev, pivots), g_row]

    # ---- 4. the serving path, counted
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    idx = rt.build_index(s_np, cfg, device=DEV)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = rt.knn_join_batched(r_np, index=idx, batch_size=BUCKET,
                              megastep=True, device=DEV)
    t_join = time.perf_counter() - t0
    launches = {"megastep": ops.launch_counts()}
    steps = res.stats.n_batches
    print(f"[{card}] slice: build_index {t_build:.3f} s, join {t_join:.3f} s "
          f"over {N_ROWS} queries = {N_ROWS / t_join:.1f} queries/s, "
          f"{steps} megasteps, launches {launches['megastep']}", flush=True)
    check(launches["megastep"]["assign"] > 0
          and launches["megastep"]["distance_topk_gather"] > 0,
          f"a kernel of the megastep path was never launched: "
          f"{launches['megastep']}")

    # ---- 5. against the float64 brute force, tie-aware
    check_exact(card, rt, "megastep join", r_np, s_np, res.distances,
                res.indices, cfg.k)

    # ---- 6. steady state: no host sync between enqueue and fetch
    eng = rt.StreamJoinEngine(idx, cfg, megastep=True,
                              device=DEV).megastep_engine
    qd, nv = eng.enqueue(r_np[:BUCKET])
    warm = eng.join_batch_device(qd, nv)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = eng.join_batch_device(qd, nv)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    check(torch.equal(out[0], warm[0]) and torch.equal(out[1], warm[1]),
          "steady state: repeated megastep differs")
    step_ms = time_ms(lambda: eng.join_batch_device(qd, nv), iters=10)
    print(f"[{card}] steady-state join_batch_device: no host sync under "
          f"set_sync_debug_mode('error'); {step_ms:.4f} ms per "
          f"{BUCKET}-query megastep", flush=True)
    profile_device(card, torch, lambda: eng.join_batch_device(qd, nv),
                   f"steady-state megastep (per step, {BUCKET} queries)",
                   out_dir / "megastep_profile.txt", runs=5)
    n_prof = 32 * BUCKET
    profile_device(card, torch, lambda: rt.knn_join_batched(
        r_np[:n_prof], index=idx, batch_size=BUCKET, megastep=True,
        device=DEV), f"knn_join_batched ({n_prof} queries, 32 batches)",
        out_dir / "join_profile.txt")

    # ---- 7. K-Q against its plain version. An explicit shortlist slack
    # pins the engine to int8 (no tuning-table cell can bypass K-Q):
    # mp = pow2(k + 118) = 128, the auto value at k = 10
    cfg_q = dataclasses.replace(cfg, quant_slack=118, reducer="gather")
    t0 = time.perf_counter()
    idx_q = rt.build_index(s_np, cfg_q, quantize="int8", device=DEV)
    torch.cuda.synchronize()
    t_build_q = time.perf_counter() - t0
    rows.append(phase_quant(card, torch, rt, idx_q, r_np, cfg_q))

    # ---- 8. the quantized path, counted
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    idx_q = rt.build_index(s_np, cfg_q, quantize="int8", device=DEV)
    res_q = rt.knn_join_batched(r_np, index=idx_q, batch_size=BUCKET,
                                quantized=True, device=DEV)
    t_quant = time.perf_counter() - t0
    launches["quantized"] = ops.launch_counts()
    st = res_q.stats
    print(f"[{card}] quantized path: build_index(int8) "
          f"{t_build_q:.3f} s alone; build + join {t_quant:.3f} s over "
          f"{N_ROWS} queries = {N_ROWS / t_quant:.1f} queries/s, "
          f"{st.n_batches} steps, mode {st.quant_mode}, mp {st.quant_mp}, "
          f"resident re-rank {st.n_resident_rerank}, host re-rank "
          f"{st.n_host_rerank}, certification fallbacks "
          f"{st.n_quant_fallback} ({st.n_quant_fallback / N_ROWS:.4%}), "
          f"resident bytes int8 {idx_q.nbytes_resident()} vs fp32 "
          f"{idx_q.nbytes_resident(quantized=False)}, launches "
          f"{launches['quantized']}", flush=True)
    check(st.quant_mode == "int8"
          and launches["quantized"]["quant_coarse_gather"] > 0,
          f"the quantized path did not run K-Q: {launches['quantized']}")
    check(st.n_quant_fallback == 0
          or launches["quantized"]["distance_topk_gather"] > 0,
          "certification fallbacks did not run the host path's K-G")
    check_exact(card, rt, "quantized join", r_np, s_np, res_q.distances,
                res_q.indices, cfg.k)
    check_same_distances("quantized join vs megastep", res_q.distances,
                         res.distances, res_q.indices, res.indices)
    qeng = rt.QuantMegastepEngine(idx_q, cfg_q, device=DEV)
    check(qeng.resident, "quant engine: expected the resident re-rank")
    qd, nv = qeng.enqueue(r_np[:BUCKET])
    warm = qeng.join_batch_device(qd, nv)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = qeng.join_batch_device(qd, nv)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(out, warm)),
          "quant steady state: repeated step differs")
    qstep_ms = time_ms(lambda: qeng.join_batch_device(qd, nv), iters=10)
    print(f"[{card}] steady-state quant join_batch_device: no host sync "
          f"under set_sync_debug_mode('error'); {qstep_ms:.4f} ms per "
          f"{BUCKET}-query step (fp32 megastep {step_ms:.4f} ms)",
          flush=True)
    profile_device(card, torch, lambda: qeng.join_batch_device(qd, nv),
                   f"steady-state quant step (per step, {BUCKET} queries)",
                   out_dir / "quant_profile.txt", runs=5)
    profile_device(card, torch, lambda: rt.knn_join_batched(
        r_np[:n_prof], index=idx_q, batch_size=BUCKET, quantized=True,
        device=DEV), f"quantized knn_join_batched ({n_prof} queries, 32 "
        f"batches)", out_dir / "quant_join_profile.txt")

    # ---- 9. the host-planned path: the paper's one-shot pipeline, pivots
    # from R, on a sample of R
    cfg_h = dataclasses.replace(cfg, n_groups=8, reducer="gather")
    r_h = r_np[:HOST_ROWS]
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plan = rt.core.plan_join(r_h, s_np, cfg_h, device=DEV)
    res_h = rt.knn_join(r_h, plan=plan, device=DEV)
    t_host = time.perf_counter() - t0
    launches["host_planned"] = ops.launch_counts()
    st = res_h.stats
    print(f"[{card}] host-planned knn_join (gather reducer, pivots from R) "
          f"over {HOST_ROWS} queries: {t_host:.3f} s with planning = "
          f"{HOST_ROWS / t_host:.1f} queries/s, replicas "
          f"{st.replicas_s}, tile selectivity {st.tile_selectivity:.4f}, "
          f"launches {launches['host_planned']}", flush=True)
    check(launches["host_planned"]["assign"] > 0
          and launches["host_planned"]["distance_topk_gather"] > 0,
          f"a kernel of the host path was never launched: "
          f"{launches['host_planned']}")
    check_exact(card, rt, "host-planned join (gather)", r_h, s_np,
                res_h.distances, res_h.indices, cfg.k)
    mega_h = rt.knn_join(r_h, index=plan.index, megastep=True, device=DEV)
    check_same_distances("host-planned join vs megastep", res_h.distances,
                         mega_h.distances, res_h.indices, mega_h.indices)
    for reducer, n in (("pruned", PRUNED_ROWS), ("dense", DENSE_ROWS)):
        t0 = time.perf_counter()
        got = rt.knn_join(r_h[:n], index=plan.index,
                          config=dataclasses.replace(cfg_h, reducer=reducer),
                          device=DEV)
        wall = time.perf_counter() - t0
        print(f"[{card}] host-planned knn_join ({reducer} reducer) over {n} "
              f"queries: {wall:.3f} s", flush=True)
        check_exact(card, rt, f"host-planned join ({reducer})", r_h[:n],
                    s_np, got.distances, got.indices, cfg.k)
        check_same_distances(f"{reducer} reducer vs megastep",
                             got.distances, mega_h.distances[:n],
                             got.indices, mega_h.indices[:n])

    # ---- 10. K-D against its plain version (retrieval and LM shapes)
    rows.append(phase_dense(card, torch, rt, s_np, r_np))

    # ---- 11. the mutable index: 16 segments, tombstones, compaction
    phase_mutable(card, torch, rt, s_np, r_np, cfg, launches, out_dir)

    # ---- 12. kNN-LM retrieval through both knn_logits routes
    phase_retrieval(card, torch, rt, s_np, r_np, launches)

    # ---- 13. the shapes the kernels refused before
    caps = phase_caps(card, torch, rt, s_np, r_np, cfg, g_forest)
    del g_forest
    torch.cuda.empty_cache()

    # ---- 14. the LM serving path at full width
    rows.append(phase_lm(card, torch, rt, launches, out_dir))

    owner = {"assign": "megastep", "distance_topk_gather": "megastep",
             "quant_coarse_gather": "quantized", "distance_topk": "retrieval",
             "flash_attention": "lm_serve"}
    for row in rows:
        if row["name"] in caps:
            row["cap_shapes"] = caps[row["name"]]
        row["launches"] = launches[owner[row["name"]]][row["name"]]
        row["launches_by_path"] = {path: n[row["name"]]
                                   for path, n in launches.items()}
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        for stream in (sys.stdout, sys.stderr):
            print(f"chip_smoke: FAILED: {e}", file=stream, flush=True)
        sys.exit(1)
