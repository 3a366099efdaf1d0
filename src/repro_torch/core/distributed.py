"""PGBJ over a device mesh: the paper's MapReduce mapping — PyTorch port
of the JAX package's ``core.distributed``.

Stage layout, one shard of a mesh per reducer:

  phase 1   (per shard) — every shard assigns its slice of the rows to
            the pivots (K-A on the card) and summarises it; ``psum`` /
            ``pmin`` / ``pmax`` merge the counts, L and U, and the
            gathered per-partition k smallest give T_S
            (:func:`distributed_phase1`; the bits of
            ``partition.assign_and_summarize``).
  planning  (host)      — θ, LB, the §5 grouping and the shuffle
            capacities from the cost model (Thm 7): the static shapes of
            the send buffers.
  phase 2a  (shuffle)   — each shard packs (group, slot)-addressed send
            buffers (rows pre-sorted by (partition, pivot distance), the
            S side straight from the index's packed layout) and one
            ``all_to_all`` per payload delivers every group its R rows
            and its Theorem-6 replicas of S.
  phase 2b  (reduce)    — per shard, the exact top-k of the received R
            rows over the received S rows **in the plan's metric**: K-D
            (``kernels.ops.distance_topk``) on rows centered by the
            index's mean for L2, ``join.join_group_dense`` for L1 / L∞;
            each over-fetches and the canonical chain re-ranks (ROADMAP
            C16: the JAX reducer selects by L2 whatever the metric).

The collectives come from ``distributed.mesh``: a ``Mesh`` runs every
shard in this process (``LocalComm``), a ``GroupComm`` runs one shard a
process over ``torch.distributed``; both give the same bits.
``distributed_knn_join(reducer="sharded")`` (the default for L2) runs
the sharded megastep (``core.sharded``) over the mesh instead: the index
partitioned once, only the final runs crossing it.

Static shapes: MapReduce shuffles ragged lists, a collective takes fixed
buffers. The capacities come from LB / T_S before the shuffle — the
paper's replication cost model (Eq. 10) made load-bearing; padding slots
carry ``valid=False``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..distributed.mesh import GroupComm, Mesh, comm_for
from ..kernels import ops
from ..kernels.sorted_merge import next_pow2
from .api import JoinPlan
from .index import QueryPlan, SIndex
from .join import join_group_dense
from .metrics import canonical_topk
from .partition import assign_to_pivots, lexsort_part_dist
from .types import JoinResult, JoinStats, SummaryTable

__all__ = ["DistributedJoinSpec", "DistributedJoinEngine",
           "build_shuffle_spec", "distributed_knn_join",
           "distributed_phase1"]


@dataclasses.dataclass(frozen=True)
class DistributedJoinSpec:
    """Static shapes of one distributed join's shuffle."""

    n_devices: int
    cap_r_send: int   # max R rows any device sends to any group
    cap_s_send: int   # max S replicas any device sends to any group
    dim: int
    k: int


def _np(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _route_counts(dest: np.ndarray, n_src: int, n_dst: int,
                  src_of_row: np.ndarray) -> int:
    """Max rows on any (src → dst) edge (a static capacity)."""
    cnt = np.zeros((n_src, n_dst), np.int64)
    np.add.at(cnt, (src_of_row, dest), 1)
    return int(cnt.max())


def _shuffle_spec(index: SIndex, qplan: QueryPlan,
                  n_devices: int) -> DistributedJoinSpec:
    """Capacities from (index, query plan), the cost model of Thm 7 —
    no row is touched."""
    n_r = qplan.n_r
    n_s = index.n_s
    src_r = (np.arange(n_r) * n_devices) // max(n_r, 1)
    cap_r = _route_counts(_np(qplan.group_of_r()), n_devices,
                          qplan.n_groups, src_r)
    src_s = (np.arange(n_s) * n_devices) // max(n_s, 1)
    ship = (_np(index.s_dist)[:, None]
            >= _np(qplan.lb_group)[_np(index.s_part)])          # (n_s, G)
    cnt = np.zeros((n_devices, qplan.n_groups), np.int64)
    np.add.at(cnt, (np.repeat(src_s, qplan.n_groups),
                    np.tile(np.arange(qplan.n_groups), n_s)), ship.ravel())
    return DistributedJoinSpec(
        n_devices=n_devices, cap_r_send=max(1, cap_r),
        cap_s_send=max(1, int(cnt.max())), dim=index.dim, k=qplan.config.k)


def build_shuffle_spec(plan: JoinPlan, n_devices: int) -> DistributedJoinSpec:
    """Capacities from the composite plan (cost model, Thm 7)."""
    return _shuffle_spec(plan.index, plan.query, n_devices)


def _pack_send_buffers(rows, aux, dest, src_of_row, n_src, n_dst, cap):
    """Host-side packing: (n_src, n_dst, cap) buffers + validity.

    ``dest`` may name a row several times (S replication; callers
    pre-expand); ``aux`` holds per-row arrays packed alongside. A stable
    sort groups rows by (src, dst), a row's rank in its bucket is its
    slot, and one scatter lands everything; the order inside a bucket is
    the input's (rows come sorted by (partition, pivot distance), so the
    received tiles are partition-coherent)."""
    n = rows.shape[0]
    nbuf = {k: np.zeros((n_src, n_dst, cap) + v.shape[1:], v.dtype)
            for k, v in aux.items()}
    buf = np.zeros((n_src, n_dst, cap, rows.shape[1]), rows.dtype)
    valid = np.zeros((n_src, n_dst, cap), bool)
    if n == 0:
        return buf, nbuf, valid
    key = src_of_row.astype(np.int64) * n_dst + dest
    order = np.argsort(key, kind="stable")
    sk = key[order]
    starts = np.flatnonzero(np.r_[True, sk[1:] != sk[:-1]])
    slot = np.arange(n) - np.repeat(starts, np.diff(np.r_[starts, n]))
    if slot.max(initial=0) >= cap:
        raise AssertionError("capacity model violated — bug in Thm 7 path")
    flat = sk * cap + slot
    buf.reshape(-1, rows.shape[1])[flat] = rows[order]
    for k, v in aux.items():
        nbuf[k].reshape((-1,) + v.shape[1:])[flat] = v[order]
    valid.reshape(-1)[flat] = True
    return buf, nbuf, valid


def _fetch_width(k: int, n_s: int) -> int:
    # over-fetch past k so the canonical re-rank, not the selection
    # arithmetic, decides the k-th neighbour among near-ties
    return max(1, min(max(next_pow2(k), 2 * k), n_s))


def _reduce(r_buf, r_valid, s_buf, s_valid, s_ids, k: int, metric: str,
            center: torch.Tensor, *, tile_r: int, tile_s: int):
    """One reducer: the exact top-k candidates of each received R row over
    the received S rows, in the plan's metric. Returns (ids (n_r_recv,
    kf) int64, pairs computed); rows of invalid slots get −1."""
    dev = r_buf.device
    n_recv = r_buf.shape[0]
    rv = torch.nonzero(r_valid)[:, 0]
    sv = torch.nonzero(s_valid)[:, 0]
    kf = _fetch_width(k, int(sv.numel()))
    out = torch.full((n_recv, kf), -1, dtype=torch.int64, device=dev)
    if rv.numel() == 0 or sv.numel() == 0:
        return out, 0
    r, s, sid = r_buf[rv], s_buf[sv], s_ids[sv]
    if metric == "l2":
        # K-D over the valid rows, centered by the index's mean (C3)
        _, pos = ops.distance_topk((r - center).contiguous(),
                                   (s - center).contiguous(), kf,
                                   bm=tile_r, bn=tile_s)
        pos = pos.to(torch.int64)
        ids = torch.where(pos >= 0, sid[torch.clamp(pos, 0)], -1)
    else:
        _, ids = join_group_dense(r, s, sid, kf, tile_r=tile_r,
                                  tile_s=tile_s, metric=metric)
    out[rv] = ids
    return out, int(rv.numel()) * int(sv.numel())


class DistributedJoinEngine:
    """The shuffle runtime over a resident index: the S side packed once
    (pivot-sorted), the R side shuffled per batch.

    ``mesh`` is a ``distributed.Mesh`` (every shard in this process) or a
    ``GroupComm`` (this process's shard of a process group; every process
    calls ``join_batch`` with the same rows and plan and gets the whole
    result). The S send buffers are cached and reused while consecutive
    batches produce the same ``lb_group``.
    """

    def __init__(self, index: SIndex, mesh, *, axis: str = "data",
                 tile_s: int = 512, tile_r: int = 128):
        self.index = index
        self.comm = comm_for(mesh)
        if isinstance(mesh, Mesh) and axis in mesh.shape \
                and mesh.shape[axis] != mesh.size:
            raise ValueError(f"the shuffle runs over every device; axis "
                             f"{axis!r} spans {mesh.shape[axis]} of "
                             f"{mesh.size}")
        self.n_dev = self.comm.n
        self.tile_s = int(tile_s)
        self.tile_r = int(tile_r)
        # home shard of each packed S row (by original row id) — static
        self._src_s_sorted = ((_np(index.s_order).astype(np.int64)
                               * self.n_dev) // max(index.n_s, 1))
        self._s_cache_key: object = None
        self._s_cache: object = None

    def _s_side(self, qplan: QueryPlan):
        """S capacity + send buffers for one plan, cached on
        ``lb_group`` (the only query-dependent input)."""
        lb_group = _np(qplan.lb_group)
        key = lb_group.tobytes()
        if self._s_cache_key == key:
            return self._s_cache
        idx = self.index
        mask = (_np(idx.s_dist_sorted)[:, None]
                >= lb_group[_np(idx.s_part_sorted)])           # (n_s, G)
        row, dst = np.nonzero(mask)   # rows already in (part, dist) order
        src = self._src_s_sorted[row]
        cnt = np.zeros((self.n_dev, qplan.n_groups), np.int64)
        np.add.at(cnt, (src, dst), 1)
        cap_s = max(1, int(cnt.max()))
        s_buf, s_aux, s_valid = _pack_send_buffers(
            _np(idx.s_sorted)[row], {"id": _np(idx.s_ids_sorted)[row]},
            dst, src, self.n_dev, self.n_dev, cap_s)
        self._s_cache_key = key
        self._s_cache = (s_buf, s_aux["id"], s_valid, row.shape[0], cap_s)
        return self._s_cache

    def join_batch(self, r, qplan: QueryPlan) -> JoinResult:
        """Job 2 for one R batch: pack, ``all_to_all``, reduce on every
        shard, then the canonical re-rank of the gathered candidates."""
        comm, n_dev, index = self.comm, self.n_dev, self.index
        if qplan.n_groups != n_dev:
            raise ValueError(f"plan has {qplan.n_groups} groups but the "
                             f"mesh has {n_dev} shards")
        cfg = qplan.config
        k, metric = cfg.k, cfg.metric
        r = np.ascontiguousarray(_np(r), np.float32)
        n_r = r.shape[0]
        g_r = _np(qplan.group_of_r())
        src_r = (np.arange(n_r) * n_dev) // max(n_r, 1)
        cap_r = max(1, _route_counts(g_r, n_dev, qplan.n_groups, src_r))
        ord_r = np.lexsort((_np(qplan.r_dist), _np(qplan.r_part)))
        r_buf, r_aux, r_valid = _pack_send_buffers(
            r[ord_r], {"id": np.arange(n_r, dtype=np.int64)[ord_r]},
            g_r[ord_r], src_r[ord_r], n_dev, n_dev, cap_r)
        s_buf, s_id, s_valid, n_replicas, cap_s = self._s_side(qplan)

        def put(x, j):
            return torch.as_tensor(np.ascontiguousarray(x),
                                   device=comm.device(j))

        shards = comm.shards
        sends = [[put(x[j], j) for j in shards]
                 for x in (r_buf, r_valid, r_aux["id"], s_buf, s_valid,
                           s_id)]
        # ---- the shuffle: one all_to_all per payload
        rb, rv, rid, sb, sv, sid = (comm.all_to_all(x) for x in sends)
        center = index.center()
        kf = _fetch_width(k, index.n_s)
        outs, pairs = [], 0
        for pos, j in enumerate(shards):
            ids, p = _reduce(
                rb[pos].reshape(-1, r.shape[1]), rv[pos].reshape(-1),
                sb[pos].reshape(-1, r.shape[1]), sv[pos].reshape(-1),
                sid[pos].reshape(-1), k, metric, center.to(comm.device(j)),
                tile_r=self.tile_r, tile_s=self.tile_s)
            ids = torch.nn.functional.pad(ids, (0, kf - ids.shape[1]),
                                          value=-1)
            outs.append(torch.stack([
                ids, torch.where(rv[pos].reshape(-1), rid[pos].reshape(-1),
                                 -1)[:, None].expand(-1, kf)]))
            pairs += p
        # ---- every reducer's candidates, gathered to every shard
        got = comm.all_gather(outs)[0].to(index.device)
        if isinstance(comm, GroupComm):
            pairs = int(comm.psum([torch.tensor([pairs])])[0][0])
        ids_all = got[:, 0].reshape(-1, kf)
        rows_all = got[:, 1, :, 0].reshape(-1)
        keep = rows_all >= 0
        cand = torch.full((n_r, kf), -1, dtype=torch.int64,
                          device=index.device)
        cand[rows_all[keep]] = ids_all[keep]
        rq = torch.as_tensor(r, device=index.device)
        d, ids = canonical_topk(rq, cand, index.rows_for_ids(cand), metric)

        stats = JoinStats(n_r=n_r, n_s=index.n_s)
        stats.n_batches = 1
        stats.replicas_s = int(n_replicas)
        stats.pivot_pairs_computed = n_r * index.n_pivots
        nr_tiles = -(-(n_dev * cap_r) // self.tile_r)
        ns_tiles = -(-(n_dev * cap_s) // self.tile_s)
        stats.tiles_total = stats.tiles_visited = n_dev * nr_tiles * ns_tiles
        stats.pairs_computed = pairs
        return JoinResult(indices=ids[:, :k].cpu().numpy(),
                          distances=d[:, :k].cpu().numpy(), stats=stats)


def distributed_knn_join(r, s, plan: JoinPlan, mesh, *, axis: str = "data",
                         tile_s: int = 512, tile_r: int = 128,
                         reducer: str = "auto",
                         batch_size: int = 4096) -> JoinResult:
    """One-shot multi-device join from a composite plan. ``s`` must be
    the dataset the plan's index was built from (or None).

    ``reducer``:

    * ``"sharded"`` — the sharded megastep (``core.sharded``): the index
      partitioned over the mesh's devices once (pivot groups → shards by
      the §5 grouping), θ global, a compacted Cor. 1 / Thm 2 schedule
      per shard, only the final runs gathered; the single-device
      megastep's distances, R in ``batch_size`` micro-batches (0: one).
      L2 only; needs a ``Mesh``.
    * ``"shuffle"`` — the MapReduce mapping of this module: the
      Theorem-6-routed ``all_to_all`` and a dense reducer per shard, in
      the plan's metric (groups must equal the shard count).
    * ``"auto"`` (default) — ``"sharded"`` for L2, else ``"shuffle"``.
    """
    if s is not None and len(s) != plan.index.n_s:
        raise ValueError(f"s has {len(s)} rows but the plan's index "
                         f"holds {plan.index.n_s}")
    metric = plan.query.config.metric
    if reducer == "auto":
        reducer = "sharded" if metric == "l2" else "shuffle"
    if reducer == "sharded":
        from .sharded import ShardedMegastepEngine
        if metric != "l2":
            raise ValueError("reducer='sharded' supports metric='l2' only; "
                             "use reducer='shuffle' for other metrics")
        if not isinstance(mesh, Mesh):
            raise ValueError("reducer='sharded' runs over a Mesh in one "
                             "process; a process group takes 'shuffle'")
        cfg = dataclasses.replace(plan.query.config, tile_s=tile_s,
                                  tile_r=tile_r)
        engine = ShardedMegastepEngine(plan.index, cfg,
                                       mesh=mesh.flat("shard"))
        rq = np.ascontiguousarray(_np(r), np.float32)
        n = rq.shape[0]
        stats = JoinStats(n_s=plan.index.n_s)
        step = batch_size if batch_size > 0 else max(n, 1)
        runs = [engine.join_batch(rq[lo:lo + step], stats=stats)
                for lo in range(0, n, step)]
        d = np.concatenate([x[0] for x in runs]) if runs else \
            np.zeros((0, cfg.k), np.float32)
        ids = np.concatenate([x[1] for x in runs]) if runs else \
            np.zeros((0, cfg.k), np.int64)
        stats.n_batches = len(runs)
        # shards partition S disjointly: every row resident once
        stats.replicas_s = plan.index.n_s
        stats.pivot_pairs_computed = (n + plan.index.n_s) \
            * plan.index.n_pivots
        return JoinResult(indices=ids, distances=d, stats=stats)
    if reducer != "shuffle":
        raise ValueError(f"unknown reducer {reducer!r}")
    engine = DistributedJoinEngine(plan.index, mesh, axis=axis,
                                   tile_s=tile_s, tile_r=tile_r)
    res = engine.join_batch(r, plan.query)
    # one-shot: this call's plan paid S-side phase 1 too
    res.stats.pivot_pairs_computed += plan.index.n_s * plan.index.n_pivots
    return res


# --------------------------------------------------------------- phase 1
def distributed_phase1(data, pivots, mesh, *, k: Optional[int] = None,
                       axis: str = "data"):
    """Job 1 over a mesh: every shard assigns its slice of the rows (K-A
    on the card, each row's distance retaken in float64) and summarises
    it; ``psum`` / ``pmin`` / ``pmax`` merge the counts, L and U, and the
    shards' per-partition k smallest, gathered, give T_S's lists.

    Returns ``(part_ids (n,) int32, dists (n,) float32, SummaryTable)``
    on the first shard's device — the bits of
    ``partition.assign_and_summarize`` (the merges are exact). Over a
    ``GroupComm`` every process passes the whole ``data`` and gets the
    whole result."""
    comm = comm_for(mesh)
    if isinstance(mesh, Mesh) and axis in mesh.shape \
            and mesh.shape[axis] != mesh.size:
        raise ValueError(f"phase 1 runs over every device; axis {axis!r} "
                         f"spans {mesh.shape[axis]} of {mesh.size}")
    x = data if isinstance(data, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(data, np.float32))
    piv = pivots if isinstance(pivots, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(pivots, np.float32))
    n, m = x.shape[0], piv.shape[0]
    n_dev = comm.n
    per = max(1, -(-n // n_dev))
    kk = 0 if k is None else int(k)
    inf = float("inf")
    parts = {name: [] for name in ("pid", "dist", "counts", "lower",
                                   "upper", "knn")}
    for j in comm.shards:
        dev = comm.device(j)
        rows = x[j * per:(j + 1) * per].to(dev)
        nj = rows.shape[0]
        pid = torch.zeros((per,), dtype=torch.int32, device=dev)
        dist = torch.zeros((per,), dtype=torch.float32, device=dev)
        counts = torch.zeros((m,), dtype=torch.int32, device=dev)
        lower = torch.full((m,), inf, device=dev)
        upper = torch.zeros((m,), device=dev)
        knn = torch.full((m, max(kk, 1)), inf, device=dev)
        if nj:
            p, d = assign_to_pivots(rows, piv.to(dev))
            pid[:nj], dist[:nj] = p, d
            p64 = p.to(torch.int64)
            counts.scatter_add_(0, p64, torch.ones_like(p))
            lower.scatter_reduce_(0, p64, d, reduce="amin")
            upper.scatter_reduce_(0, p64, d, reduce="amax")
            if kk:
                # the shard's k smallest per partition, as in _summarize
                order = lexsort_part_dist(p, d)
                sp, sd = p64[order], d[order]
                idx = torch.arange(nj, device=dev)
                start = torch.full((m,), nj, dtype=torch.int64, device=dev)
                start.scatter_reduce_(0, sp, idx, reduce="amin")
                rank = idx - start[sp]
                slot = torch.where(rank < kk, sp * kk + rank, m * kk)
                flat = torch.full((m * kk + 1,), inf, device=dev)
                flat.scatter_(0, slot, sd)
                knn = flat[:m * kk].reshape(m, kk)
        for name, v in zip(parts, (pid, dist, counts, lower, upper, knn)):
            parts[name].append(v)
    counts = comm.psum(parts["counts"])[0]
    lower = comm.pmin(parts["lower"])[0]
    upper = comm.pmax(parts["upper"])[0]
    pid = comm.all_gather(parts["pid"])[0].reshape(-1)[:n]
    dist = comm.all_gather(parts["dist"])[0].reshape(-1)[:n]
    knn = None
    if kk:
        g = comm.all_gather(parts["knn"])[0]               # (n_dev, m, kk)
        knn = torch.sort(g.permute(1, 0, 2).reshape(m, -1),
                         dim=1).values[:, :kk].contiguous()
    return pid, dist, SummaryTable(counts=counts, lower=lower, upper=upper,
                                   knn_dists=knn)

