"""Distance-based outlier detection via a kNN self-join on the PyTorch
port — the paper's §1 motivating application (Knorr & Ng; LOF-style
k-distance scores). The port's twin of ``examples/outlier_detection.py``.

An object is an outlier if its distance to its k-th nearest neighbor is
large; one PGBJ self-join computes every object's score in one pass.

Run:  PYTHONPATH=src python examples/outlier_detection_torch.py [--device cpu]

Runs on the card; ``--device cpu`` runs the kernels' plain PyTorch
versions. ``--n`` shrinks the data for a CPU test.
"""
import argparse

import numpy as np

from repro_torch import JoinConfig, forest_like, knn_join
from repro_torch.device import resolve_device


def main(argv=None) -> dict:
    """Runs the self-join; returns the numbers it prints."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=12000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    rng = np.random.default_rng(0)
    data = forest_like(args.n, dim=8, seed=0)
    # plant 20 outliers far outside the clusters
    outliers = rng.uniform(3000, 4000, (20, 8)).astype(np.float32)
    full = np.concatenate([data, outliers]).astype(np.float32)

    k = 10
    res = knn_join(full, full, config=JoinConfig(
        k=k + 1, n_pivots=128, n_groups=9), device=dev)  # +1: self at 0
    k_dist = res.distances[:, -1]              # distance to k-th true NN

    thresh = np.quantile(k_dist[:len(data)], 0.999) * 2
    flagged = np.where(k_dist > thresh)[0]
    planted = set(range(len(data), len(full)))
    found = planted & set(flagged.tolist())
    print(f"self-join over {len(full)} objects, k={k}, on {dev}")
    print(f"  selectivity   : {res.stats.selectivity:.4f}")
    print(f"  flagged       : {len(flagged)} objects above 2×p99.9 k-distance")
    print(f"  planted found : {len(found)}/20")
    assert len(found) == 20, "all planted outliers must be detected"
    precision = len(found) / max(len(flagged), 1)
    print(f"  precision     : {precision:.2f}")
    print("outlier detection via one kNN join ✓")
    return dict(n_objects=len(full), selectivity=res.stats.selectivity,
                flagged=len(flagged), found=len(found), precision=precision)


if __name__ == "__main__":
    main()
