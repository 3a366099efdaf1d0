#!/usr/bin/env python3
"""Time the host-planned route, the int8 tier (whose certification
fallbacks run that route) and the fp32 megastep's steady step of one
checkout over Forest-like rows, on one NVIDIA GPU.

    python3 tools/bench_host_route.py [--src DIR] [--queries 65536]
                                      [--reps 2]

``--src`` is the ``src`` directory of the checkout whose ``repro_torch``
is timed (default: this repository's); its kernels are built there, at
first use. To compare two versions, run this script over each checkout
in turns (A, B, B, A) on one card, one after another. It builds the
index over 581,012 Forest-like rows at ``chip_smoke.py``'s settings (k =
10, 256 pivots), then times ``--reps`` runs each (the card synchronized
before and after; the first run of each includes its warm-up) of the
host-planned ``knn_join`` (gather reducer, 8 groups) and of
``knn_join_batched(quantized=True)`` with the int8 tier pinned
(``quant_slack=118``), over ``--queries`` Forest-like queries in
4096-query batches, and ``--reps`` times the mean time of 20 steady
``MegastepEngine.join_batch_device`` calls on one 4096-query bucket
(CUDA events, ``chip_smoke.time_ms``). It prints one JSON line: the
card's name and power limit, the wall seconds of each run, the step
times in ms, the fallback count and SHA-256s of
both results' distance bytes and of their id bytes (equal across
versions exactly when those outputs are bit for bit equal). The card
line is ``chip_smoke.py``'s. Imports nothing of JAX."""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--queries", type=int, default=65_536)
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("bench_host_route: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, args.src)
    import repro_torch as rt
    torch.backends.cuda.matmul.allow_tf32 = False
    s = rt.forest_like(581_012, 10, seed=0)
    r = rt.forest_like(args.queries, 10, seed=1)
    cfg = rt.JoinConfig(k=10, n_pivots=256, tile_r=128, tile_s=512)
    out = {"card": cs.card_line(), "src": args.src}

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    idx = rt.build_index(s, cfg, device="cuda")
    cfg_h = dataclasses.replace(cfg, n_groups=8, reducer="gather")
    cfg_q = dataclasses.replace(cfg, quant_slack=118, reducer="gather")
    idx_q = rt.build_index(s, cfg_q, quantize="int8", device="cuda")
    d_hash, i_hash = hashlib.sha256(), hashlib.sha256()
    for name, run in (
            ("host_s", lambda: rt.knn_join(r, index=idx, config=cfg_h,
                                           device="cuda")),
            ("quant_s", lambda: rt.knn_join_batched(
                r, index=idx_q, batch_size=4096, quantized=True,
                device="cuda"))):
        out[name] = []
        for _ in range(args.reps):
            res, wall = timed(run)
            out[name].append(wall)
        d_hash.update(res.distances.tobytes())
        i_hash.update(res.indices.tobytes())
        if name == "quant_s":
            out["fallbacks"] = int(res.stats.n_quant_fallback)
    eng = rt.MegastepEngine(idx, cfg, device="cuda")
    qd, nv = eng.enqueue(r[:4096])
    out["megastep_step_ms"] = [
        cs.time_ms(lambda: eng.join_batch_device(qd, nv), iters=20)
        for _ in range(args.reps)]
    out["dist_sha256"] = d_hash.hexdigest()
    out["ids_sha256"] = i_hash.hexdigest()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
