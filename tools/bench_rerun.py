#!/usr/bin/env python3
"""Time the exact re-run of uncertified K-G runs
(``repro_torch.core.megastep.rerun_scheduled``) at several R-tile sizes,
on one NVIDIA GPU.

    python3 tools/bench_rerun.py [--rows 581012] [--queries 16384]
                                 [--tiles 128,256,512,1024]

It builds the megastep's payload over ``--rows`` OSM-like rows (seed 17)
at ``chip_smoke.py``'s phase-4 config (k = 10, 256 pivots, tiles 128 ×
512), then re-runs ``--queries`` of those rows, drawn without
replacement (seed 0), once per tile size after one warm-up run, the
card synchronized around each. It prints one JSON line: the card's name
and power limit (``chip_smoke.py``'s line) and per tile size the wall
seconds and whether its distances and ids equal the first size's (they
must: every tile size re-runs over a sound superset of each query's
neighbours). Imports nothing of JAX."""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=581_012)
    ap.add_argument("--queries", type=int, default=16_384)
    ap.add_argument("--tiles", default="128,256,512,1024")
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("bench_rerun: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch as rt
    from repro_torch.core import megastep
    x = rt.osm_like(args.rows, seed=17)
    cfg = rt.JoinConfig(k=10, n_pivots=256, tile_r=128, tile_s=512)
    eng = rt.MegastepEngine(rt.build_index(x, cfg, device="cuda"), cfg,
                            device="cuda")
    q = torch.from_numpy(x[np.random.default_rng(0).choice(
        args.rows, args.queries, replace=False)])
    out = {"card": cs.card_line(), "rows": args.rows,
           "queries": args.queries, "wall_s": {}, "same": {}}
    first = None
    for bm in (int(t) for t in args.tiles.split(",")):
        for _ in range(2):                  # the first is the warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            d, ids = megastep.rerun_scheduled(
                q, eng._payload_shards(), k=cfg.k, bn=eng._bn,
                home=eng.device, bm=bm)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        first = first or (d.cpu(), ids.cpu())
        out["wall_s"][bm] = wall
        out["same"][bm] = bool(torch.equal(first[0], d.cpu())
                               and torch.equal(first[1], ids.cpu()))
    print(json.dumps(out), flush=True)
    return 0 if all(out["same"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())
