"""The port's MapReduce mapping over a mesh (``repro_torch.core.distributed``)
against the JAX package's, on the CPU: ``distributed_knn_join`` (the
sharded reducer and the shuffle), ``distributed_phase1``, and the same
calls over a gloo process group.

Tolerances: across the packages, distances within 4 ulp (ROADMAP C1) and
ids equal except among tied distances; phase 1's assignment ids equal
and its distances within the expanded-d² rounding of the JAX side (the
port retakes each row's distance in float64). Inside the port, every
result is the float64 oracle's distances bit for bit, and the process
group gives the in-process mesh's bits.

ROADMAP C16: the JAX shuffle reducer selects by expanded L2 whatever the
plan's metric, so its L1 / L∞ joins miss neighbours; the port's reducer
selects in the plan's metric and is exact. The JAX side runs once, in a
subprocess with 8 forced host devices, at a tiny size.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch as rt  # noqa: E402
from repro_torch.core.distributed import (_pack_send_buffers,  # noqa: E402
                                          distributed_knn_join,
                                          distributed_phase1)
from repro_torch.core.partition import assign_and_summarize  # noqa: E402
from repro_torch.distributed import make_mesh  # noqa: E402

from torch_parity import assert_d_close, assert_same_join  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
N_R, N_S, DIM, K, N_DEV = 200, 400, 5, 5, 8


def _rows():
    rng = np.random.default_rng(7)
    return (rng.normal(size=(N_R, DIM)).astype(np.float32) * 2,
            rng.normal(size=(N_S, DIM)).astype(np.float32) * 2)


def _mesh(n, name="data"):
    return make_mesh((n,), (name,), devices=["cpu"] * n)


def _plan(r, s, metric="l2", n_groups=N_DEV):
    cfg = rt.JoinConfig(k=K, n_pivots=16, n_groups=n_groups,
                        grouping="geometric", metric=metric)
    return rt.core.plan_join(r, s, cfg, device="cpu")


_JAX_SCRIPT = """
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import numpy as np
    from repro.core import JoinConfig, assign_and_summarize, plan_join
    from repro.core.distributed import distributed_knn_join, \\
        distributed_phase1
    from repro.core.jax_compat import make_mesh

    rng = np.random.default_rng(7)
    R = rng.normal(size=(200, 5)).astype(np.float32) * 2
    S = rng.normal(size=(400, 5)).astype(np.float32) * 2
    mesh = make_mesh((8,), ("data",))
    out = {}
    for metric in ("l2", "l1", "linf"):
        cfg = JoinConfig(k=5, n_pivots=16, n_groups=8, grouping="geometric",
                         metric=metric)
        plan = plan_join(R, S, cfg)
        if metric == "l2":
            res = distributed_knn_join(R, S, plan, mesh, reducer="sharded")
            out["sharded.d"], out["sharded.i"] = res.distances, res.indices
        res = distributed_knn_join(R, S, plan, mesh, reducer="shuffle")
        out[f"shuffle_{metric}.d"] = res.distances
        out[f"shuffle_{metric}.i"] = res.indices
    piv = S[:16]
    pid, dist, t = distributed_phase1(S, piv, mesh, k=4)
    out["p1.pid"], out["p1.dist"] = pid, dist
    out["p1.counts"], out["p1.knn"] = t.counts, t.knn_dists
    np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_distributed") / "ref.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(_JAX_SCRIPT), str(path)],
        env=env, capture_output=True, text=True, timeout=400)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(path))


@pytest.fixture(scope="module")
def oracle():
    r, s = _rows()
    return {m: rt.brute_force_knn(r, s, K, metric=m, device="cpu")
            for m in ("l2", "l1", "linf")}


@pytest.mark.parametrize("reducer", ["sharded", "shuffle"])
def test_l2_join_matches_jax_and_oracle(jax_ref, oracle, reducer):
    r, s = _rows()
    res = distributed_knn_join(r, s, _plan(r, s), _mesh(N_DEV),
                               reducer=reducer)
    bd, bi = oracle["l2"]
    assert np.array_equal(res.distances, bd)
    key = "sharded" if reducer == "sharded" else "shuffle_l2"
    assert_same_join(res.distances, res.indices, jax_ref[f"{key}.d"],
                     jax_ref[f"{key}.i"])


@pytest.mark.parametrize("metric", ["l1", "linf"])
def test_c16_metric_shuffle_exact_where_jax_misses(jax_ref, oracle, metric):
    """The JAX shuffle reducer picks neighbours by L2 under an L1 / L∞
    plan and misses rows against the oracle; the port's is exact."""
    r, s = _rows()
    bd, bi = oracle[metric]
    jd = jax_ref[f"shuffle_{metric}.d"]
    assert (np.abs(jd - bd) > 1e-5).any(axis=1).sum() > 0
    res = distributed_knn_join(r, s, _plan(r, s, metric), _mesh(N_DEV),
                               reducer="shuffle")
    assert np.array_equal(res.distances, bd)
    mism = res.indices != bi
    assert np.array_equal(res.distances[mism], bd[mism])


def test_phase1_matches_jax_and_host(jax_ref):
    r, s = _rows()
    piv = torch.from_numpy(s[:16])
    p0, d0, t0 = assign_and_summarize(torch.from_numpy(s), piv, k=4)
    pid, dist, t = distributed_phase1(s, piv, _mesh(N_DEV), k=4)
    assert torch.equal(pid, p0) and torch.equal(dist, d0)
    for f in ("counts", "lower", "upper", "knn_dists"):
        assert torch.equal(getattr(t, f), getattr(t0, f)), f
    assert np.array_equal(pid.numpy(), jax_ref["p1.pid"])
    assert np.array_equal(t.counts.numpy(), jax_ref["p1.counts"])
    rows = np.concatenate([s, s[:16]])
    assert_d_close(dist.numpy(), jax_ref["p1.dist"], rows)
    fin = np.isfinite(jax_ref["p1.knn"])
    assert (np.isfinite(t.knn_dists.numpy()) == fin).all()
    assert_d_close(t.knn_dists.numpy()[fin], jax_ref["p1.knn"][fin], rows)


@pytest.mark.parametrize("n", [1, 3, 8])
def test_phase1_any_shard_count(n):
    _, s = _rows()
    piv = torch.from_numpy(s[:16])
    p0, d0, t0 = assign_and_summarize(torch.from_numpy(s), piv, k=4)
    pid, dist, t = distributed_phase1(s, piv, _mesh(n), k=4)
    assert torch.equal(pid, p0) and torch.equal(dist, d0)
    assert torch.equal(t.knn_dists, t0.knn_dists)


def test_pack_send_buffers_matches_jax():
    from repro.core.distributed import _pack_send_buffers as jpack
    rng = np.random.default_rng(3)
    rows = rng.normal(size=(90, 4)).astype(np.float32)
    aux = {"id": np.arange(90, dtype=np.int64)}
    dest = rng.integers(0, 3, 90)
    src = rng.integers(0, 2, 90)
    a = jpack(rows, aux, dest, src, 2, 3, 40)
    b = _pack_send_buffers(rows, aux, dest, src, 2, 3, 40)
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[2], b[2])
    assert np.array_equal(a[1]["id"], b[1]["id"])


def test_shuffle_spec_bounds_the_shuffle():
    """Thm 7's capacities, from the plan alone, bound what the shuffle
    ships: every R row and every Theorem-6 replica has a slot."""
    from repro_torch.core.distributed import build_shuffle_spec
    r, s = _rows()
    plan = _plan(r, s)
    spec = build_shuffle_spec(plan, N_DEV)
    res = distributed_knn_join(r, s, plan, _mesh(N_DEV), reducer="shuffle")
    assert (spec.n_devices, spec.dim, spec.k) == (N_DEV, DIM, K)
    assert spec.cap_r_send * N_DEV * N_DEV >= N_R
    assert spec.cap_s_send * N_DEV * N_DEV >= res.stats.replicas_s


def test_shuffle_needs_groups_equal_to_shards():
    r, s = _rows()
    with pytest.raises(ValueError, match="groups"):
        distributed_knn_join(r, s, _plan(r, s, n_groups=4), _mesh(8),
                             reducer="shuffle")
    with pytest.raises(ValueError, match="l2"):
        distributed_knn_join(r, s, _plan(r, s, "l1"), _mesh(8),
                             reducer="sharded")


# ---------------------------------------------------- gloo process group

def _pg_worker(rank, world, store_path, out_path):
    import torch.distributed as dist
    from repro_torch.distributed import GroupComm
    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world)
    try:
        comm = GroupComm(device="cpu")
        r, s = _rows()
        out = {}
        for metric in ("l2", "l1"):
            res = distributed_knn_join(r, s, _plan(r, s, metric, world),
                                       comm, reducer="shuffle")
            out[f"{metric}.d"], out[f"{metric}.i"] = (res.distances,
                                                      res.indices)
        pid, d, t = distributed_phase1(s, torch.from_numpy(s[:16]), comm,
                                       k=4)
        out["pid"], out["dist"], out["knn"] = (pid.numpy(), d.numpy(),
                                               t.knn_dists.numpy())
        np.savez(f"{out_path}.{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("world", [2, 4])
def test_process_group_matches_in_process_mesh(tmp_path, world):
    """The shuffle join and phase 1 over a gloo group of ``world``
    processes (a FileStore under the test's tmp dir) give every rank the
    in-process mesh's bits."""
    import torch.multiprocessing as mp
    out_path = str(tmp_path / "pg")
    ctx = mp.start_processes(_pg_worker, args=(world, str(tmp_path / "fs"),
                                               out_path),
                             nprocs=world, join=False, start_method="spawn")
    deadline = 240.0
    import time
    t0 = time.monotonic()
    while not ctx.join(timeout=5):
        if time.monotonic() - t0 > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"the {world}-process group did not finish in "
                        f"{deadline} s")
    r, s = _rows()
    mesh = _mesh(world)
    ref = {}
    for metric in ("l2", "l1"):
        res = distributed_knn_join(r, s, _plan(r, s, metric, world), mesh,
                                   reducer="shuffle")
        ref[f"{metric}.d"], ref[f"{metric}.i"] = res.distances, res.indices
    pid, d, t = distributed_phase1(s, torch.from_numpy(s[:16]), mesh, k=4)
    ref["pid"], ref["dist"], ref["knn"] = (pid.numpy(), d.numpy(),
                                           t.knn_dists.numpy())
    for rank in range(world):
        got = np.load(f"{out_path}.{rank}.npz")
        for key, v in ref.items():
            assert np.array_equal(got[key], v), (rank, key)
