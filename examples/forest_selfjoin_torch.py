"""Paper §6 experiment in miniature on the PyTorch port: a Forest-like
self-join comparing PGBJ / PBJ / H-BRJ on time, selectivity, and
shuffling cost. The port's twin of ``examples/forest_selfjoin.py``.

The JAX script's docstring also promises a distributed (shard_map) run of
the same join; its code never makes one, and neither does this port of
it (``examples/distributed_join_torch.py`` runs the join over a mesh).

Run:  PYTHONPATH=src python examples/forest_selfjoin_torch.py [--n 20000]
          [--device cpu]

Runs on the card (K-A in PGBJ's and PBJ's phase 1); ``--device cpu``
runs the kernels' plain PyTorch versions.
"""
import argparse
import time

import numpy as np

from repro_torch import (JoinConfig, brute_force_knn, forest_like, hbrj_join,
                         knn_join, pbj_join)
from repro_torch.device import resolve_device


def main(argv=None) -> dict:
    """Runs the three joins; returns the numbers it prints, by method."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=20000)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    data = forest_like(args.n, 10, seed=0)
    k = args.k
    print(f"Forest-like self-join  n={args.n}  k={k}  on {dev}\n")
    print(f"{'method':8s} {'time_s':>8s} {'selectivity':>12s} {'shuffle':>10s}")

    cfg = JoinConfig(k=k, n_pivots=min(256, args.n // 50), n_groups=9)
    runs = {
        "PGBJ": lambda: knn_join(data, data, config=cfg, device=dev),
        "PBJ": lambda: pbj_join(data, data, k,
                                JoinConfig(k=k, n_pivots=cfg.n_pivots),
                                n_reducers=9, device=dev),
        "H-BRJ": lambda: hbrj_join(data, data, k, n_reducers=9, device=dev),
    }
    results, out = {}, {}
    for name, run in runs.items():
        t0 = time.perf_counter()
        res = results[name] = run()
        wall = time.perf_counter() - t0
        print(f"{name:8s} {wall:8.2f} {res.stats.selectivity:12.4f} "
              f"{res.stats.shuffle_tuples:10d}")
        out[name] = dict(time_s=wall, selectivity=res.stats.selectivity,
                         shuffle_tuples=res.stats.shuffle_tuples)

    # exactness cross-check on a sample
    sample = np.random.default_rng(0).choice(args.n, 500, replace=False)
    bd, _ = brute_force_knn(data[sample], data, k, device=dev)
    for res in results.values():
        assert np.allclose(res.distances[sample], bd, atol=1e-2)
    print("\nall three methods exact ✓")
    return out


if __name__ == "__main__":
    main()
