"""Quickstart on the PyTorch port: exact kNN join in five lines, verified
against brute force. The port's twin of ``examples/quickstart.py``.

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

Runs on the card (the join's nearest-pivot assignment on K-A); ``--device
cpu`` runs the kernels' plain PyTorch versions. ``--r-rows`` and
``--s-rows`` shrink the join for a CPU test.
"""
import argparse

import numpy as np

from repro_torch import JoinConfig, brute_force_knn, forest_like, knn_join
from repro_torch.device import resolve_device


def main(argv=None) -> dict:
    """Runs the join; returns the numbers it prints and the result."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--r-rows", type=int, default=10000)
    ap.add_argument("--s-rows", type=int, default=16000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # R ⋉ S: for every row of R, the k nearest rows of S
    R = forest_like(args.r_rows, dim=10, seed=0)
    S = forest_like(args.s_rows, dim=10, seed=1)
    cfg = JoinConfig(k=10, n_pivots=256, n_groups=9,
                     pivot_strategy="random", grouping="geometric")
    res = knn_join(R, S, config=cfg, device=dev)

    bd, _ = brute_force_knn(R, S, 10, device=dev)
    assert np.allclose(res.distances, bd, atol=1e-2)
    st = res.stats
    naive = len(R) + cfg.n_groups * len(S)
    print(f"joined |R|={len(R)} × |S|={len(S)}, k=10 on {dev} — exact ✓")
    print(f"  computation selectivity : {st.selectivity:.4f}  (Eq. 13)")
    print(f"  shuffle tuples          : {st.shuffle_tuples}"
          f"  (naive: {naive})")
    print(f"  avg replicas of S       : {st.replicas_s / len(S):.2f}")
    print(f"  tile selectivity        : {st.tile_selectivity:.4f}")
    return dict(selectivity=st.selectivity, shuffle_tuples=st.shuffle_tuples,
                naive_shuffle=naive, avg_replicas=st.replicas_s / len(S),
                tile_selectivity=st.tile_selectivity, config=cfg, result=res)


if __name__ == "__main__":
    main()
