#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--out DIR]

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` (nvcc,
first use), holds each against its plain PyTorch version at the shapes
its path gives it, then drives three paths at the paper's data scale —
Forest CoverType's 581,012 rows × 10 attributes: the fused megastep
(``build_index`` → ``knn_join_batched(megastep=True)``), the int8
quantized tier (``build_index(quantize="int8")`` →
``knn_join_batched(quantized=True)``), both over all of R in 4096-query
batches, and the paper's host-planned one-shot ``knn_join`` on a sample
of R — and checks each against a float64 brute force and against each
other. Phases:

1. card, versions, kernel build;
2. K-A (nearest pivot) vs its plain version, n = 581,012, M = 256, d = 10;
3. K-G (scheduled gather top-k) vs its plain version on one 4096-query
   bucket with the schedule the megastep's stage 3 made for it and ~1 %
   of the rows dead;
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
   force and bitwise against the megastep on the same index.

Every time printed stands beside the card's name and power limit. The
line before the last two is one JSON object with each kernel's launches,
error, times and bound; the line before the last is the card's name and
power limit; the last is ``{"ok": true, "device": {...}}``. Any failure
exits non-zero before those lines. Long reports (nvcc's ``ptxas``
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
DIM = 10
BUCKET = 4096
HOST_ROWS = 65_536        # R sample of the host-planned gather path
PRUNED_ROWS = 512         # R samples of the pruned and dense reducers
DENSE_ROWS = 2048
DEV = "cuda"
H100_HBM_BYTES_S = 3.35e12    # H100 SXM data sheet
H100_FP32_FLOPS_S = 67e12     # fp32 on CUDA cores, no tensor cores
H100_INT8_OPS_S = 1979e12     # int8 tensor-core peak (dense)


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


def phase_gather(card, torch, rt, s_np, r_np, cfg):
    """K-G vs its plain version on one bucket at the megastep's shapes."""
    import numpy as np
    from repro_torch.core.megastep import assign_bounds_schedule
    from repro_torch.kernels import distance_topk as kg
    from repro_torch.kernels.sorted_merge import next_pow2

    idx = rt.build_index(s_np, cfg, device=DEV)
    eng = rt.MegastepEngine(idx, cfg, device=DEV)
    pl = eng.payload()
    q, n_valid = eng.enqueue(r_np[:BUCKET])
    bm, bn, kp = cfg.tile_r, cfg.tile_s, next_pow2(cfg.k)
    _, qcs, _, _, sched, cnt = assign_bounds_schedule(q, n_valid, pl,
                                                      k=cfg.k, bm=bm)
    rng = np.random.default_rng(7)
    alive = pl.alive.clone()
    dead = torch.as_tensor(rng.choice(idx.n_s, idx.n_s // 100,
                                      replace=False), device=DEV)
    alive[dead] = 0.0
    s_c = pl.s_c
    args = (qcs, s_c, kp, sched, cnt)
    kw = dict(alive=alive, bm=bm, bn=bn)
    d_k, p_k = kg.distance_topk_gather_cuda(*args, **kw)
    d_p, p_p = kg.distance_topk_gather_plain(*args, **kw)
    torch.cuda.synchronize()
    full = p_p >= 0
    check(bool((full == (p_k >= 0)).all()),
          "K-G: empty slots differ from the plain version")
    pk, pp = p_k.long().clamp(min=0), p_p.long().clamp(min=0)
    check(not bool(((alive[pk] <= 0) & full).any()),
          "K-G: a dead row entered the kernel's runs")
    q64 = qcs.double()
    s64 = s_c.double()
    s2 = (s64 * s64).sum(1)
    tol = pair_tol((q64 * q64).sum(1)[:, None],
                   torch.maximum(s2[pk], s2[pp]), q64.shape[1])
    d2_k, d2_p = d_k.double() ** 2, d_p.double() ** 2
    used = float(torch.where(full, (d2_k - d2_p).abs() / tol, 0.0).max())
    check(used <= 1.0, "K-G: run distances disagree with the plain version")
    # tie-aware positions: each position's exact d² sits at its rank's
    # order statistic within tolerance, in both runs (the kernel's exact
    # d² is off its own d² by half of ``tol``, and that off the plain
    # version's by ``tol``)
    ex_k = ((q64[:, None, :] - s64[pk]) ** 2).sum(-1)
    ex_p = ((q64[:, None, :] - s64[pp]) ** 2).sum(-1)
    check(bool(((((ex_k - d2_p).abs() <= 1.5 * tol)
                 & ((ex_p - d2_p).abs() <= 0.5 * tol)) | ~full).all()),
          "K-G: positions differ beyond near-ties")
    same = float((p_k == p_p).double().mean())
    err = float((d_k - d_p).abs().max())
    ms = time_ms(lambda: kg.distance_topk_gather_cuda(*args, **kw), iters=20)
    plain_ms = time_ms(lambda: kg.distance_topk_gather_plain(*args, **kw),
                       warmup=1, iters=3)
    nr_tiles, ns_tiles = sched.shape[0], pl.s.shape[0] // bn
    counts = cnt.long()
    slot = torch.arange(sched.shape[1], device=DEV)[None, :]
    visited = sched.long()[slot < counts[:, None]]       # (Σ cnt,) tiles
    live_per_tile = (alive.reshape(ns_tiles, bn) > 0).sum(1)
    pairs = float(bm * live_per_tile[visited].sum())
    tiles = torch.unique(visited)
    d = qcs.shape[1]
    n_bytes = (4.0 * qcs.numel() + tiles.numel() * bn * (4.0 * d + 4.0)
               + 4.0 * (int(counts.sum()) + nr_tiles) + 8.0 * q.shape[0] * kp)
    b_ms, b_by = bound(n_bytes, pairs * (2 * d + 3))
    frac = float(counts.sum()) / (nr_tiles * ns_tiles)
    print(f"[{card}] K-G gather top-k bucket={q.shape[0]} kp={kp} bm={bm} "
          f"bn={bn}: visited-tile fraction {frac:.4f}, positions equal "
          f"{same:.6f} (rest near-ties), max |dist err| {err:.3e}, max "
          f"|d² err| {used:.3e} of its pair's tolerance "
          f"({tol_text(tol[full])}); kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms "
          f"({b_by})", flush=True)
    return dict(name="distance_topk_gather", route="cuda",
                source="src/repro_torch/csrc/gather_topk.cu",
                replaces="src/repro/kernels/distance_topk.py:189",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None)


def phase_quant(card, torch, rt, idx, r_np, cfg):
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
                       warmup=1, iters=3)
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
    print(f"[{card}] K-Q int8 coarse scan bucket={qi.shape[0]} mp={mp} "
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


def check_exact(card, rt, what: str, r_np, s_np, d, i, k: int) -> None:
    """A join result against the float64 brute force on 2048 sampled
    queries (all of them when fewer), tie-aware: distances within 4 ulp (equal bits
    expected: both report the canonical chain), every reported id's
    true distance within the true k-th, no duplicate ids."""
    import numpy as np
    check(d.shape == (r_np.shape[0], k) and bool(np.isfinite(d).all())
          and bool((i >= 0).all()), f"{what}: malformed result")
    n = r_np.shape[0]
    sample = np.random.default_rng(3).choice(n, min(2048, n),
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
    print(f"[{card}] {what} vs brute force (fp64) on {len(sample)} "
          f"queries: max |dist diff| {float(np.abs(got_d - bd).max()):.3e}, "
          f"ids equal {float((got_i == bi).mean()):.6f} (rest exact ties)",
          flush=True)


def check_same_distances(what: str, d, ref_d, i, ref_i) -> None:
    """Two routes' canonical distances bit for bit; ids may differ only
    where the distances tie."""
    import numpy as np
    check(np.array_equal(d, ref_d),
          f"{what}: distances not bitwise the reference route's")
    mism = i != ref_i
    check(np.array_equal(d[mism], ref_d[mism]),
          f"{what}: ids differ beyond ties")


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
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
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
    rows = [phase_assign(card, torch, rt, s_dev, pivots),
            phase_gather(card, torch, rt, s_np, r_np, cfg)]

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

    owner = {"assign": "megastep", "distance_topk_gather": "megastep",
             "quant_coarse_gather": "quantized"}
    for row in rows:
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
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
