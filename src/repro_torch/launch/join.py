"""kNN-join launcher: the paper's §6 workload as a CLI. PyTorch port of
the JAX package's ``launch.join``.

  PYTHONPATH=src python -m repro_torch.launch.join --dataset forest \\
      --n 20000 --k 10 --pivots 256 --groups 9 [--method pgbj|pbj|hbrj] \\
      [--expand T] [--grouping greedy] [--verify] [--device cpu] \
      [--distributed [--shards N] [--simulate]]

A self-join of the dataset (``--expand T``: the paper's "Forest×T").
Runs on the card; ``--device cpu`` runs the plain PyTorch versions of
the kernels. ``--distributed`` runs PGBJ over a mesh of ``--shards``
devices (``core.distributed.distributed_knn_join``: the sharded
megastep for L2), one pivot group a shard; the default is every card
present, and more shards than cards (or than the one CPU) need
``--simulate``, which puts them all on ``--device``. ``--verify`` holds 500 sampled rows against the float64
brute force (distances bit for bit, ids within the true k-th distance)
and exits 1 on a miss.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np

from ..core import JoinConfig, brute_force_knn, knn_join, plan_join
from ..core.baselines import hbrj_join, pbj_join
from ..data import expand_dataset, forest_like, osm_like
from ..device import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", choices=["forest", "osm"], default="forest")
    ap.add_argument("--n", type=int, default=20000)
    ap.add_argument("--dim", type=int, default=10)
    ap.add_argument("--expand", type=int, default=1)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--pivots", type=int, default=256)
    ap.add_argument("--groups", type=int, default=9)
    ap.add_argument("--pivot-strategy", default="random",
                    choices=["random", "farthest", "kmeans"])
    ap.add_argument("--grouping", default="geometric",
                    choices=["geometric", "greedy", "none"])
    ap.add_argument("--method", default="pgbj",
                    choices=["pgbj", "pbj", "hbrj"])
    ap.add_argument("--distributed", action="store_true",
                    help="execution over a mesh of devices")
    ap.add_argument("--shards", type=int, default=0,
                    help="mesh size for --distributed (default: the cards "
                         "present, 1 on the CPU)")
    ap.add_argument("--simulate", action="store_true",
                    help="--distributed: every shard on --device (more "
                         "shards than devices)")
    ap.add_argument("--verify", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    mesh = _mesh(args, dev) if args.distributed else None

    data = (forest_like(args.n, args.dim) if args.dataset == "forest"
            else osm_like(args.n))
    data = expand_dataset(data, args.expand)
    cfg = JoinConfig(k=args.k, n_pivots=args.pivots, n_groups=args.groups,
                     pivot_strategy=args.pivot_strategy,
                     grouping=args.grouping)
    t0 = time.perf_counter()
    if args.method == "pgbj" and mesh is not None:
        from ..core.distributed import distributed_knn_join
        cfg = dataclasses.replace(cfg, n_groups=mesh.size)
        plan = plan_join(data, data, cfg, device=dev)
        res = distributed_knn_join(data, data, plan, mesh)
    elif args.method == "pgbj":
        res = knn_join(data, data, config=cfg, device=dev)
    elif args.method == "pbj":
        res = pbj_join(data, data, args.k, cfg, n_reducers=args.groups,
                       device=dev)
    else:
        res = hbrj_join(data, data, args.k, n_reducers=args.groups,
                        device=dev)
    dt = time.perf_counter() - t0

    s = res.stats
    where = (f"{mesh.size} shards on {sorted(set(map(str, mesh.devices)))}"
             if mesh is not None else str(dev))
    print(f"{args.method} on {args.dataset} n={data.shape[0]} k={args.k}: "
          f"{dt:.2f}s on {where}")
    print(f"  selectivity={s.selectivity:.4f} shuffle={s.shuffle_tuples} "
          f"alpha={s.replicas_s / max(s.n_s, 1):.2f}")
    if args.verify:
        sample = np.random.default_rng(0).choice(
            data.shape[0], min(500, data.shape[0]), replace=False)
        bd, bi = brute_force_knn(data[sample], data, args.k, device=dev)
        ok = verify_sample(data, sample, res.distances[sample],
                           res.indices[sample], bd, bi)
        print(f"  verified vs brute force on {len(sample)} samples: {ok}")
        if not ok:
            raise SystemExit(1)
    return res


def _mesh(args, dev):
    """The ``--distributed`` mesh: ``--shards`` devices (default: the
    cards present, or the one CPU); past the devices there are, only with
    ``--simulate``, every shard then on ``dev``."""
    import torch

    from ..distributed.mesh import make_mesh
    have = (torch.cuda.device_count() if dev.type == "cuda" else 1)
    n = args.shards or have
    if args.simulate:
        return make_mesh((n,), ("data",), devices=[dev] * n)
    if n > have:
        raise ValueError(
            f"--shards {n} exceeds the {have} {dev.type} device(s); pass "
            f"--simulate to put every shard on {dev}")
    devices = ([torch.device("cuda", j) for j in range(n)]
               if dev.type == "cuda" else [dev])
    return make_mesh((n,), ("data",), devices=devices)


def verify_sample(data: np.ndarray, sample: np.ndarray, d: np.ndarray,
                  ids: np.ndarray, bd: np.ndarray, bi: np.ndarray) -> bool:
    """A join's rows ``sample`` against the float64 oracle's ``(bd, bi)``:
    distances bit for bit (both report the canonical chain), no
    duplicate or missing id in a row, and every reported id within the
    true k-th distance (float64; ties and near-ties within 1e-6
    relative may list another id)."""
    if not np.array_equal(d, bd) or (ids < 0).any():
        return False
    srt = np.sort(ids, axis=1)
    if (srt[:, 1:] == srt[:, :-1]).any():
        return False
    q = data[sample].astype(np.float64)[:, None, :]

    def dist(rows):
        return np.sqrt(((q - data[rows].astype(np.float64)) ** 2).sum(-1))

    return bool((dist(ids) <= dist(bi[:, -1:]) * (1 + 1e-6) + 1e-6).all())


if __name__ == "__main__":
    main()
