#!/usr/bin/env python3
"""Time the paper's §6 three-way comparison (PGBJ, PBJ, H-BRJ) with the
host reducers' L2 selection in float64 (``core.metrics.select_dist``,
as the port ships) and in float32 (``core.metrics.cmp_dist``, the
expansion the JAX package selects on), on one NVIDIA GPU.

    python3 tools/bench_select.py [--rows 65536] [--dataset forest|osm]
                                  [--order 64,32,32,64]

A self-join of ``--rows`` rows at ``chip_smoke.py``'s phase-16 settings
(k = 10, 9 reducers, 128 pivots), each method once per entry of
``--order`` (float64 and float32 selection in turns, so drift on the
card lands on both). Each run prints one JSON line: the card's name and
power limit, the dataset, the method, the selection's precision, the
wall seconds (the card synchronized before and after) and whether the
distances are bitwise the float64 oracle's. Imports nothing of JAX."""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
import chip_smoke as cs  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=65536)
    ap.add_argument("--dataset", choices=["forest", "osm"], default="forest")
    ap.add_argument("--order", default="64,32,32,64")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    import repro_torch as rt
    from repro_torch.core import join as join_mod
    from repro_torch.core.metrics import cmp_dist, select_dist

    def float32_select(a, b, metric="l2", *, block=2048):
        return cmp_dist(a, b, metric, block=block)

    card = cs.card_line() if args.device == "cuda" else "cpu"
    k, x = cs.PAPER_K, (rt.forest_like(args.rows, cs.DIM, seed=16)
                        if args.dataset == "forest"
                        else rt.osm_like(args.rows, seed=16))
    bd, _ = rt.brute_force_knn(x, x, k, device=args.device)
    runs = {
        "pgbj": lambda: rt.knn_join(x, x, config=rt.JoinConfig(
            k=k, n_pivots=cs.PAPER_PIVOTS, n_groups=cs.PAPER_REDUCERS),
            device=args.device),
        "pbj": lambda: rt.pbj_join(
            x, x, k, rt.JoinConfig(k=k, n_pivots=cs.PAPER_PIVOTS),
            n_reducers=cs.PAPER_REDUCERS, device=args.device),
        "hbrj": lambda: rt.hbrj_join(x, x, k, n_reducers=cs.PAPER_REDUCERS,
                                     device=args.device)}
    sync = (torch.cuda.synchronize if args.device == "cuda"
            else (lambda: None))
    for bits in (int(b) for b in args.order.split(",")):
        join_mod.select_dist = select_dist if bits == 64 else float32_select
        for method, run in runs.items():
            sync()
            t0 = time.perf_counter()
            res = run()
            sync()
            wall = time.perf_counter() - t0
            print(json.dumps(dict(
                card=card, dataset=args.dataset, rows=args.rows,
                method=method, selection=f"float{bits}", wall_s=wall,
                exact=bool(np.array_equal(res.distances, bd)))), flush=True)
    join_mod.select_dist = select_dist
    return 0


if __name__ == "__main__":
    sys.exit(main())
