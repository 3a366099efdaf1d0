#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--out DIR]

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` (nvcc,
first use), holds each against its plain PyTorch version at the shapes
the serving path gives it, then drives the serving path once at the
paper's data scale — Forest CoverType's 581,012 rows × 10 attributes,
``build_index`` → ``knn_join_batched(megastep=True)`` over all of R in
4096-query batches — and checks the result against a float64 brute
force. Phases:

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
   and of a 32-batch ``knn_join_batched``.

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
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
N_ROWS = 581_012          # UCI Covertype
DIM = 10
BUCKET = 4096
DEV = "cuda"
H100_HBM_BYTES_S = 3.35e12    # H100 SXM data sheet
H100_FP32_FLOPS_S = 67e12     # fp32 on CUDA cores, no tensor cores


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


def bound(n_bytes: float, flops: float) -> tuple[float, str]:
    t_b = n_bytes / H100_HBM_BYTES_S * 1e3
    t_f = flops / H100_FP32_FLOPS_S * 1e3
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
    _, qcs, _, sched, cnt = assign_bounds_schedule(q, n_valid, pl, k=cfg.k,
                                                   bm=bm)
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
    launches = ops.launch_counts()
    steps = res.stats.n_batches
    print(f"[{card}] slice: build_index {t_build:.3f} s, join {t_join:.3f} s "
          f"over {N_ROWS} queries = {N_ROWS / t_join:.1f} queries/s, "
          f"{steps} megasteps, launches {launches}", flush=True)
    check(launches["assign"] > 0 and launches["distance_topk_gather"] > 0,
          f"a kernel of the path was never launched: {launches}")
    check(res.distances.shape == (N_ROWS, cfg.k)
          and bool(np.isfinite(res.distances).all())
          and bool((res.indices >= 0).all()), "slice: malformed result")
    for row in rows:
        row["launches"] = launches[row["name"]]

    # ---- 5. against the float64 brute force, tie-aware
    sample = np.random.default_rng(3).choice(N_ROWS, 2048, replace=False)
    bd, bi = rt.brute_force_knn(r_np[sample], s_np, cfg.k, device=DEV)
    got_d, got_i = res.distances[sample], res.indices[sample]
    # the port and the oracle report the same canonical chain, so equal
    # neighbor sets give equal bits; 4 ulp covers a tie broken otherwise
    ulp = np.spacing(np.maximum(bd, 1.0).astype(np.float32))
    check(bool((np.abs(got_d - bd) <= 4 * ulp).all()),
          "brute force: reported distances off beyond 4 ulp")
    q64 = r_np[sample].astype(np.float64)
    s64 = s_np.astype(np.float64)
    true_d = np.sqrt(((q64[:, None, :] - s64[got_i]) ** 2).sum(-1))
    kth = np.sqrt(((q64[:, None, :] - s64[bi[:, -1:]]) ** 2).sum(-1))
    check(bool((true_d <= kth * (1 + 1e-6) + 1e-6).all()),
          "brute force: a reported id lies beyond the true k-th distance")
    check(all(len(set(r)) == cfg.k for r in got_i.tolist()),
          "brute force: duplicate ids in a row")
    print(f"[{card}] brute force (fp64) on 2048 queries: max |dist diff| "
          f"{float(np.abs(got_d - bd).max()):.3e}, ids equal "
          f"{float((got_i == bi).mean()):.6f} (rest exact ties)", flush=True)

    # ---- 6. steady state: no host sync between enqueue and fetch
    eng = rt.StreamJoinEngine(idx, cfg, device=DEV).megastep_engine
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
