"""Distributed PGBJ join over a device mesh on the PyTorch port, with
fault-tolerant group execution (retries + speculative backup tasks). The
port's twin of ``examples/distributed_join.py``.

The JAX script forces 8 XLA host devices; this one takes ``--shards 8
--simulate`` as ``repro_torch.launch.join`` does: every shard on
``--device``. Without ``--simulate`` it takes one card a shard and raises,
as ``make_mesh`` does, when there are fewer cards than shards.

Run:  PYTHONPATH=src python examples/distributed_join_torch.py \\
          [--shards 8] [--simulate] [--device cpu]

Runs on the card (phase 1 on K-A, the sharded megastep on K-G); ``--device
cpu`` runs the kernels' plain PyTorch versions (``--simulate`` then puts
every shard on the one CPU). ``--r-rows`` and ``--s-rows`` shrink the
join for a CPU test.
"""
import argparse
import threading

import numpy as np

from repro_torch import JoinConfig, brute_force_knn, forest_like
from repro_torch.core import plan_join
from repro_torch.core.distributed import distributed_knn_join
from repro_torch.device import resolve_device
from repro_torch.distributed import make_mesh
from repro_torch.distributed.fault import GroupExecutor, regroup


def mesh_of(n: int, dev, simulate: bool):
    """A 1-D mesh of ``n`` shards along "data": all on ``dev`` with
    ``simulate``, else one card a shard (``make_mesh`` raises past the
    cards present, and on the CPU past its one device)."""
    if simulate:
        return make_mesh((n,), ("data",), devices=[dev] * n)
    if dev.type == "cpu":
        if n > 1:
            raise ValueError(f"{n} shards on the CPU need --simulate")
        return make_mesh((1,), ("data",), devices=[dev])
    return make_mesh((n,), ("data",))


def main(argv=None) -> dict:
    """Runs the join, the elastic shrink and the group execution; returns
    the numbers it prints."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--shards", type=int, default=8)
    ap.add_argument("--simulate", action="store_true",
                    help="put every shard on --device")
    ap.add_argument("--r-rows", type=int, default=4000)
    ap.add_argument("--s-rows", type=int, default=6000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    n_dev = args.shards
    mesh = mesh_of(n_dev, dev, args.simulate)
    print(f"devices: {n_dev} shards on "
          f"{', '.join(sorted(set(map(str, mesh.devices))))}")
    R = forest_like(args.r_rows, 8, seed=0)
    S = forest_like(args.s_rows, 8, seed=1)
    cfg = JoinConfig(k=10, n_pivots=64, n_groups=n_dev)
    plan = plan_join(R, S, cfg, device=dev)
    res = distributed_knn_join(R, S, plan, mesh)
    bd, _ = brute_force_knn(R, S, 10, device=dev)
    assert np.allclose(res.distances, bd, atol=1e-2)
    print(f"distributed join exact on {n_dev}-device mesh ✓  "
          f"(replicas shipped: {res.stats.replicas_s})")

    # elastic: re-run on half the devices without re-planning phase 1
    half = n_dev // 2
    plan_h = regroup(plan, half)
    res_h = distributed_knn_join(R, S, plan_h,
                                 mesh_of(half, dev, args.simulate))
    assert np.allclose(res_h.distances, bd, atol=1e-2)
    print(f"elastic shrink {n_dev}→{half} devices, still exact ✓")

    # fault-tolerant group execution with injected failures
    fails = {1: 1}
    lock = threading.Lock()

    def group_fn(g):
        with lock:
            if fails.get(g, 0) > 0:
                fails[g] -= 1
                raise RuntimeError("injected node failure")
        # Theorem 6: the S rows that ship to group g (packed layout)
        mask = plan.index.replica_mask_sorted(plan.query.lb_group, g)
        return int(mask.sum())

    ex = GroupExecutor(max_retries=2, speculate=True)
    runs = ex.run(group_fn, list(range(plan.query.n_groups)))
    attempts = {g: (r.attempts, r.result) for g, r in sorted(runs.items())}
    print("group execution with injected failure:", attempts)
    assert all(r.done for r in runs.values())
    print("fault-tolerant execution ✓")
    return dict(shards=n_dev, replicas_s=res.stats.replicas_s,
                replicas_s_half=res_h.stats.replicas_s,
                attempts={g: a for g, (a, _) in attempts.items()},
                shipped={g: n for g, (_, n) in attempts.items()})


if __name__ == "__main__":
    main()
