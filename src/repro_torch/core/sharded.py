"""Sharded megastep: one logical datastore across a device mesh —
PyTorch port of the JAX package's ``core.sharded``.

The fused megastep (``core.megastep``) holds the whole index payload on
one device. Here the paper's shuffle becomes **mesh partitioning**:
pivot groups are placed on shards by the §5 geometric grouping
(``SIndex.shard_packing``), each shard holds only its groups' packed
rows (+ int8 twins for the quantized tier) and their Thm-2 tile stats on
its own mesh device, and the assign → θ → schedule → gather-top-k →
exact re-rank body runs once per shard:

* **θ is global, schedules are per shard.** Every shard carries the
  replicated pivot geometry and T_S pivot-kNN lists of all segments and
  the index's global mean as its center (C3), so stages 1–2
  (``megastep.assign_theta``) give the single-device values on every
  shard — they run once per distinct device. The visit masks read the
  shard's own tile stats: partitions a shard does not hold are never
  ``present``, so its schedule visits only local tiles.
* **Only final runs cross the mesh.** Each shard's K-G run gets its
  exact d², canonical distances and ids on the shard, then the kp-wide
  runs are gathered to the mesh's first device and folded by the tree
  merge (``kernels.sorted_merge.tree_merge_runs``) in K-G's own order —
  its distance, then the row's packed position on one device — so the
  fold keeps the kp rows one device's K-G would keep, whatever the shard
  order; ``certify.select_run`` takes the k and certifies the run as on
  one device.
* **No steady-state host sync.** The payload (rows, masks, geometry) is
  uploaded at refresh; a batch is one upload of the queries, device to
  device copies to the other devices, and the launches.

Exactness under sharding: every row lives on exactly one serving shard,
whose schedule visits every row within θ, and every row outside the
merged run has float32 d² at least its last value, so the merged run
certifies as one device's does; a certified run and an exact re-run both
give the k first live rows in (exact d², id) order. So the shard count
changes neither the distances nor the ids, ties included.

**Fault tolerance.** ``SIndex.shard_packing(r=...)`` places each pivot
group on a primary plus ``r − 1`` backups; :class:`ShardHealth`, fed by
the ``sharded.*`` fault sites and bounded attempt timeouts, picks a
per-partition owner view (``ShardPacking.owner_view``). Failover is a
mask swap: only the ``alive`` and ``present`` masks are re-uploaded
(masked rows canonicalise to (+inf, −1) like padding), never the rows.
With no live replica the surviving shards' runs still merge, and each
query carries a sound certified recall bound (:func:`coverage_bound`);
``recover()`` rebuilds and re-uploads the payload behind
``refresh_lock`` without blocking serving.
"""
from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import threading
from typing import Optional, Union

import numpy as np
import torch

from .. import obs
from ..device import resolve_device
from ..distributed.mesh import Mesh, make_mesh
from ..kernels import ops
from ..kernels.sorted_merge import tree_merge_runs
from ..serve import faultinject
from .certify import run_width, select_run
from .megastep import (JoinHandle, MegastepEngine, StepOut, _Payload,
                       _SegGeom, assign_theta, merge_state, run_columns,
                       schedule_visits, segment_excess)
from .metrics import sq_dist64
from .types import JoinConfig, JoinStats

__all__ = ["ShardHealth", "ShardedMegastepEngine", "coverage_bound"]


class ShardHealth:
    """Thread-safe failed-shard tracker for one sharded engine.

    ``mark_failed`` records a failed shard and bumps ``generation``; the
    engine's payload cache keys on it, so the next refresh rebuilds the
    serving view (the failover masks) without re-uploading rows.
    ``reset`` restores full health. Timeouts with no attributable shard
    only count — the view cannot change without knowing whom to evict."""

    def __init__(self, n_shards: int):
        self.n_shards = int(n_shards)
        self._lock = threading.Lock()
        self._failed: set = set()
        self.generation = 0
        self.n_faults = 0
        self.n_timeouts = 0

    @property
    def failed(self) -> frozenset:
        with self._lock:
            return frozenset(self._failed)

    def mark_failed(self, shard: Optional[int]) -> bool:
        """Record a shard failure; True iff it newly changed the view."""
        with self._lock:
            self.n_faults += 1
            if shard is None:
                return False
            shard = int(shard)
            if not (0 <= shard < self.n_shards) or shard in self._failed:
                return False
            self._failed.add(shard)
            self.generation += 1
            return True

    def note_timeout(self) -> None:
        with self._lock:
            self.n_timeouts += 1

    def reset(self) -> None:
        with self._lock:
            self._failed.clear()
            self.generation += 1


@dataclasses.dataclass
class _ShardedPayload:
    """Per-shard megastep payloads (shard j on the mesh's j-th device)
    plus what the degraded-coverage bound reads, on the first device."""

    shards: tuple             # per-shard _Payload (or _QuantPayload)
    gpos: tuple               # per shard, each row's single-device
                              # packed position (int64; padding 2^62)
    dead_total: int
    pivots: tuple             # per segment (M, dim) raw pivots
    upper: tuple              # per segment (M,) float64 T_S upper bounds
    # per segment (M,) bool, the populated groups no live shard serves;
    # None while every group is covered
    uncovered: Optional[tuple] = None

    @property
    def segs(self) -> tuple:
        return self.shards[0].segs


def coverage_bound(q: torch.Tensor, pl: _ShardedPayload,
                   th: torch.Tensor) -> torch.Tensor:
    """The per-query certified degraded-coverage bound lm (B,) float32:
    +inf while every pivot group is served. Otherwise every row of an
    uncovered group p lies at least max(|q, p| − U(p), 0) away (triangle
    inequality on the pivot), and θ bounds whatever a schedule pruned,
    so a reported neighbour with d ≤ lm = min(min_p lb_p, θ) is provably
    in the true global top-k. Taken in float64 against U rounded up, and
    rounded down past one float32 ulp, so a float32 distance's own
    rounding cannot carry a neighbour over it."""
    b = q.shape[0]
    if pl.uncovered is None:
        return torch.full((b,), float("inf"), device=q.device)
    inf = float("inf")
    lb_min = torch.full((b,), inf, dtype=torch.float64, device=q.device)
    for piv, up, unc in zip(pl.pivots, pl.upper, pl.uncovered):
        lb = torch.clamp(torch.sqrt(sq_dist64(q, piv)) - up[None, :], min=0.0)
        lb = torch.where(unc[None, :], lb, inf)
        lb_min = torch.minimum(lb_min, lb.min(1).values)
    lm = torch.minimum(lb_min, th.to(torch.float64))
    lm32 = lm.to(torch.float32)
    down = torch.full_like(lm32, -inf)
    lm32 = torch.where(lm32.to(torch.float64) > lm,
                       torch.nextafter(lm32, down), lm32)
    return torch.where(torch.isfinite(lm32), torch.nextafter(lm32, down),
                       lm32)


def _round_up(x: torch.Tensor) -> torch.Tensor:
    x = x.to(torch.float32)
    return torch.nextafter(x, torch.full_like(x, float("inf")))


def _per_device(q: torch.Tensor, pl: _ShardedPayload, devices, n_valid: int,
                k: int):
    """Stages 1–2 once per distinct mesh device: {device: (q on it,
    assign_theta's outputs)}."""
    out = {}
    for sp, dev in zip(pl.shards, devices):
        key = str(dev)
        if key not in out:
            qj = q if dev == q.device else q.to(dev, non_blocking=True)
            out[key] = (qj, assign_theta(qj, n_valid, sp, k=k))
    return out


# the packed position of a padding slot: past every real row
_NO_POS = 1 << 62


def _sharded_megastep(q: torch.Tensor, n_valid: int, pl: _ShardedPayload,
                      *, k: int, bm: int, bn: int, devices, state=None):
    """The fp32 megastep over every shard: per-shard schedule, K-G and
    the run's columns (``megastep.run_columns``), the runs gathered to
    ``q``'s device and merged. Returns a device ``megastep.StepOut``,
    ``lm`` the degraded-coverage bound (+inf on a fully served mesh).

    The merge keeps what one device's K-G would: the kp rows first in
    K-G's own order — its distance, then the packed position, which
    each shard's positions follow. Every row outside the merged run has
    float32 d² at least its last value, so ``certify.select_run`` takes
    the k and certifies the merged run as it does one device's, and the
    result is one device's, ties included."""
    kp = run_width(k)
    home = q.device
    inf = float("inf")
    pre = _per_device(q, pl, devices, n_valid, k)
    runs, th, q_norm = [], None, None
    for sp, gpos, dev in zip(pl.shards, pl.gpos, devices):
        _, (qs, qcs, valid_s, inv, th_q, qps, homes) = pre[str(dev)]
        sched, cnt = schedule_visits(qps, homes, th_q, valid_s, sp.segs,
                                     bm=bm)
        dk, pos = ops.distance_topk_gather(qcs, sp.s_c, kp, sched, cnt,
                                           alive=sp.alive, bm=bm, bn=bn)
        f, x, ids, d_can = run_columns(qs, sp, dk, pos)
        pos_c = torch.clamp(pos.to(torch.int64), 0, sp.s.shape[0] - 1)
        run = (f, torch.where(pos >= 0, gpos[pos_c], _NO_POS), x, ids,
               d_can)
        runs.append(tuple(y[inv].to(home, non_blocking=True) for y in run))
        if th is None:
            th = th_q[inv].to(home, non_blocking=True)
            q_norm = torch.linalg.vector_norm(
                qcs[inv].to(torch.float64), dim=1).to(home,
                                                      non_blocking=True)
    f, _, x, ids, d_can = runs[0] if len(runs) == 1 \
        else tree_merge_runs(runs)
    d, ids, unc = select_run(f, x, ids, d_can, q_norm, k, q.shape[1])
    unc &= torch.arange(q.shape[0], device=home) < n_valid
    lm = coverage_bound(q, pl, th)
    if state is not None:
        if len(state) > 2:                # min of two sound bounds
            lm = torch.minimum(lm, state[2])
        d, ids = merge_state(d, ids, state, k)
    return StepOut(d, ids, lm, unc)


class _ShardedPayloadMixin:
    """What the fp32 and int8 sharded engines share: the mesh, the
    shard-laid-out payload, its health-driven serving view and the
    placement of every piece on its shard's device. Mixed in before the
    single-device engine so its payload build wins the MRO."""

    def _init_mesh(self, n_shards: Optional[int], mesh: Optional[Mesh],
                   device=None):
        if mesh is not None:
            if device is not None and \
                    resolve_device(device).type != mesh.devices[0].type:
                raise ValueError(f"the mesh lives on {mesh.devices[0]}, "
                                 f"the engine was asked for {device}")
            if mesh.axis_names != ("shard",):
                raise ValueError(
                    f"the sharded megastep needs a 1-D mesh with a 'shard' "
                    f"axis, got axes {mesh.axis_names}")
            if n_shards is not None and int(n_shards) != mesh.size:
                raise ValueError(f"n_shards={n_shards} disagrees with the "
                                 f"mesh's 'shard' extent {mesh.size}")
        elif resolve_device(device).type == "cpu":    # the one CPU
            n = 1 if n_shards is None else int(n_shards)
            if n != 1:
                raise ValueError(
                    f"n_shards={n_shards} on the one CPU; for simulated "
                    f"shards pass a mesh with an explicit device list, "
                    f"e.g. make_mesh(({n},), ('shard',), "
                    f"devices=['cpu'] * {n})")
            mesh = make_mesh((1,), ("shard",), devices=[device])
        else:
            if n_shards is None:      # every card (make_mesh names none)
                n_shards = max(1, torch.cuda.device_count())
            if int(n_shards) < 1:
                raise ValueError(f"n_shards must be >= 1, got {n_shards}")
            mesh = make_mesh((int(n_shards),), ("shard",))
        self.mesh = mesh
        self.n_shards = mesh.size
        self.health = ShardHealth(self.n_shards)
        self.replication = 1
        self.attempt_timeout: Optional[float] = None
        self._attempt_pool = None
        self._cov_cache = None
        self._recover_lock = threading.Lock()

    def _place(self, index) -> None:
        # queries land on, and results merge on, the mesh's first device
        self.device = self.mesh.devices[0]
        self._rows_on_device = True

    def _payload_shards(self) -> tuple:
        """The payloads an exact re-run reads: every shard's serving
        view (each row once: it masks the other replicas)."""
        return self.payload().shards

    def _put_shard(self, x: np.ndarray, j: int) -> torch.Tensor:
        """Commit shard j's piece of the partitioned payload to its
        device. A ``ShardFault`` armed here stands in for a device lost
        while its slice was being uploaded."""
        faultinject.fire("sharded.shard_upload")
        return torch.as_tensor(np.ascontiguousarray(x),
                               device=self.mesh.devices[j])

    def dispatch(self, queries, *, stats=None):
        if stats is not None:
            stats.n_shards = self.n_shards
        return super().dispatch(queries, stats=stats)

    def nbytes_per_shard(self, *,
                         quantized: Optional[bool] = None) -> np.ndarray:
        """Resident row-payload bytes per shard, summed over the live
        segments (``SIndex.nbytes_resident(n_shards=...)`` reports the
        largest)."""
        segs, _, _ = self._index_parts()
        out = np.zeros((self.n_shards,), np.int64)
        for si, _ in segs:
            qz = ((si.config.quantize != "none")
                  if quantized is None else quantized)
            sp = si.shard_packing(self.n_shards, self._bn,
                                  r=self.replication)
            out += sp.nbytes_per_shard(quantized=qz)
        return out

    # ---- the shard-laid-out payload

    def _build_struct(self, segs) -> dict:
        """The version-independent payload: per shard, its rows (raw and
        centered), ids and tile stats on its device, and the replicated
        geometry (once per distinct device)."""
        n_sh, r, bn, k = self.n_shards, self.replication, self._bn, \
            self.config.k
        packs = [(si, off, si.shard_packing(n_sh, bn, r=r))
                 for si, off in segs]
        # the single-device center, bit for bit: the same rows in the
        # same (segment, packed) order, the same float64 mean
        center = torch.cat([si.s_sorted for si, _ in segs]) \
            .to(torch.float64).mean(0).to(torch.float32)
        n_finite_total = 0
        geo = []
        for si, _, _ in packs:
            kk = min(k, si.t_s.knn_dists.shape[1])
            knn = si.t_s.knn_dists[:, :kk].contiguous()
            n_finite_total += int(torch.isfinite(knn).sum())
            geo.append((si.pivots - center, si.pivd,
                        si.pivots.to(torch.float64), segment_excess(si),
                        knn))
        rep = {}
        for dev in self.mesh.devices:
            if str(dev) not in rep:
                rep[str(dev)] = (center.to(dev), [
                    tuple(x.to(dev).contiguous() for x in g) for g in geo])
        # where each segment starts in the single-device layout (every
        # segment padded to whole tiles), and its rows' packed positions
        starts = np.cumsum([0] + [max(1, -(-si.n_s // bn)) * bn
                                  for si, _, _ in packs])
        inv = [si.s_inv.cpu().numpy() for si, _, _ in packs]
        shards = []
        for j, dev in enumerate(self.mesh.devices):
            c_j, geo_j = rep[str(dev)]
            rows = np.concatenate([sp.rows[j] for _, _, sp in packs])
            gids = np.concatenate(
                [np.where(sp.gids_local[j] >= 0, sp.gids_local[j] + off, -1)
                 for _, off, sp in packs])
            gpos = np.concatenate(
                [np.where(sp.gids_local[j] >= 0,
                          start + inv_g[np.maximum(sp.gids_local[j], 0)],
                          _NO_POS)
                 for (_, _, sp), start, inv_g in zip(packs, starts, inv)])
            s = self._put_shard(rows, j)
            geoms = tuple(
                _SegGeom(pivots_c=pc, pivd=pivd, pivots64=p64, excess=exc,
                         knn=knn,
                         sd_min=self._put_shard(sp.sd_min[j], j),
                         sd_max=self._put_shard(sp.sd_max[j], j),
                         present=self._put_shard(sp.present[j], j))
                for (pc, pivd, p64, exc, knn), (_, _, sp)
                in zip(geo_j, packs))
            shards.append(dict(center=c_j, geoms=geoms, s=s,
                               s_c=(s - c_j).contiguous(), gids_np=gids,
                               gids=self._put_shard(gids, j),
                               gpos=self._put_shard(gpos, j)))
        home = self.mesh.devices[0]
        return dict(
            packs=tuple(sp for _, _, sp in packs), shards=shards,
            primary=int(np.argmax([si.n_s for si, _ in segs])),
            n_finite_total=n_finite_total,
            pivots=tuple(si.pivots.to(home) for si, _, _ in packs),
            # U rounded up: the float32 table may sit half an ulp below
            # the float64 maximum it rounds
            upper=tuple(_round_up(si.t_s.upper).to(home, torch.float64)
                        for si, _, _ in packs))

    def _shard_payload(self, st: dict, j: int, sh: dict, segs: tuple,
                       alive: torch.Tensor, dead_total: int) -> _Payload:
        return _Payload(center=sh["center"], segs=segs,
                        primary=st["primary"], s=sh["s"], s_c=sh["s_c"],
                        gids=sh["gids"], alive=alive, dead_total=dead_total,
                        n_finite_total=st["n_finite_total"])

    def payload(self) -> _ShardedPayload:
        """The sharded payload of the index's current version under the
        current serving view, rebuilt under ``refresh_lock`` when either
        moved. A view change re-uploads the masks only."""
        with self.refresh_lock:
            segs, tomb, vkey = self._index_parts()
            key = vkey + ("health", self.health.generation)
            if self._payload is not None and self._payload[0] == key:
                return self._payload[1]
            if not segs:
                raise ValueError("megastep over an empty index")
            with obs.span("sharded.refresh", n_segments=len(segs),
                          n_shards=self.n_shards,
                          generation=self.health.generation):
                obs.metrics.REGISTRY.counter(
                    "megastep_payload_refresh_total").inc()
                faultinject.fire("megastep.payload_upload")
                skey = (tuple(id(si) for si, _ in segs), self._bn,
                        self.config.k)
                if self._struct is None or self._struct[0] != skey:
                    self._struct = (skey, self._build_struct(segs))
                pl = self._make_view(self._struct[1], tomb)
                self._payload = (key, pl)
                return pl

    def _make_view(self, st: dict, tomb: np.ndarray) -> _ShardedPayload:
        failed = self.health.failed
        view = self.replication > 1 or bool(failed)
        owners = [sp.owner_view(failed) for sp in st["packs"]]
        serve = ([sp.serve_mask(o) for sp, o in zip(st["packs"], owners)]
                 if view else None)
        shards = []
        for j, sh in enumerate(st["shards"]):
            alive = sh["gids_np"] >= 0
            if tomb.size:
                alive &= ~np.isin(sh["gids_np"], tomb)
            segs = sh["geoms"]
            if view:
                alive &= np.concatenate([m[j] for m in serve])
                segs = tuple(dataclasses.replace(
                    g, present=self._put_shard(sp.present_view(o)[j], j))
                    for g, sp, o in zip(segs, st["packs"], owners))
            shards.append(self._shard_payload(
                st, j, sh, segs,
                self._put_shard(alive.astype(np.float32), j),
                int(tomb.size)))
        unc = [sp.uncovered_parts(o) for sp, o in zip(st["packs"], owners)]
        home = self.mesh.devices[0]
        return _ShardedPayload(
            shards=tuple(shards),
            gpos=tuple(sh["gpos"] for sh in st["shards"]),
            dead_total=int(tomb.size),
            pivots=st["pivots"], upper=st["upper"],
            uncovered=(tuple(torch.as_tensor(u, device=home) for u in unc)
                       if failed and any(u.any() for u in unc) else None))


class ShardedMegastepEngine(_ShardedPayloadMixin, MegastepEngine):
    """``MegastepEngine`` over a 1-D "shard" mesh: the same dispatch() /
    finalize() surface and the same distances, with the index payload
    partitioned across the shards by ``SIndex.shard_packing`` (see the
    module docstring).

    ``mesh`` names the devices (``distributed.make_mesh``; simulated
    shards need an explicit device list); without it ``n_shards`` (None:
    every card) takes the present cards and raises past their count,
    or the one CPU when ``device="cpu"``. ``device`` defaults to the
    mesh's, and without a mesh to the card.

    ``replication=r`` places every pivot group on a primary plus r − 1
    backup shards. On a shard failure (a ``ShardFault`` at a
    ``sharded.*`` site, or ``attempt_timeout`` expiring) the engine
    marks the shard failed and raises ``ShardFailedError``; the next
    attempt serves the updated owner view — the same bits while every
    populated group keeps a live replica, certified degraded coverage
    (per-query ``rb`` from :meth:`finalize_covered`) once groups are
    lost. :meth:`recover` re-uploads and re-admits failed shards.
    """

    def __init__(self, index, config: Optional[JoinConfig] = None, *,
                 n_shards: Optional[int] = None, mesh: Optional[Mesh] = None,
                 bucket_min: int = 16, replication: int = 1,
                 attempt_timeout: Optional[float] = None,
                 device: Optional[Union[str, torch.device]] = None):
        self._init_mesh(n_shards, mesh, device)
        replication = int(replication)
        if replication < 1:
            raise ValueError(f"replication must be >= 1, got {replication}")
        self.replication = min(replication, self.n_shards)
        self.attempt_timeout = (float(attempt_timeout)
                                if attempt_timeout else None)
        MegastepEngine.__init__(self, index, config, bucket_min=bucket_min,
                                device=index.device)
        self._place(index)

    def join_batch_device(self, q_dev: torch.Tensor, n_valid: int, *,
                          state=None):
        """The steady-state call: device queries in, a device
        ``megastep.StepOut`` out, no host sync (``lm``: the
        degraded-coverage bound, +inf on a fully served mesh). ``state``
        optionally carries a previous ``(dists, ids[, lm])`` for the
        same slots."""
        return self._mega_call(self.payload(), q_dev, n_valid, state)

    def _mega_call(self, payload: _ShardedPayload, q_dev: torch.Tensor,
                   n_valid: int, state=None):
        """Launch the sharded megastep against an already-refreshed
        payload — lock-free, so a bounded attempt's worker thread never
        takes ``refresh_lock``."""
        bucket = int(q_dev.shape[0])
        bm = min(bucket, self._bm_cap)
        with obs.span("sharded.device_step", bucket=bucket, bm=bm,
                      n_shards=self.n_shards) as sp:
            out = _sharded_megastep(q_dev, n_valid, payload,
                                    k=self.config.k, bm=bm, bn=self._bn,
                                    devices=self.mesh.devices, state=state)
            sp.set(outcome="launched")
        self.step_count += 1
        return out

    # ---- failure handling

    def _shard_failed(self, fault) -> faultinject.ShardFailedError:
        """Mark the fault's shard failed and turn the fault into the
        retriable ``ShardFailedError`` (the next attempt serves the
        updated owner view)."""
        shard = getattr(fault, "shard", None)
        self.health.mark_failed(shard)
        self._cov_cache = None
        obs.event("sharded.failover_remask", shard=shard,
                  generation=self.health.generation,
                  n_failed=len(self.health.failed))
        reg = obs.metrics.REGISTRY
        reg.counter("shard_failover_total").inc()
        reg.gauge("shard_failed").set(len(self.health.failed))
        reg.gauge("shard_generation").set(self.health.generation)
        return faultinject.ShardFailedError(
            shard, f"shard {shard} failed "
                   f"({len(self.health.failed)}/{self.n_shards} down): "
                   f"{fault}")

    def _bounded_attempt(self, fn, what: str):
        """Run one attempt under ``attempt_timeout`` so a hung shard or
        collective surfaces as a ``ShardFailedError``. ``fn`` must not
        take ``refresh_lock`` (the caller may hold it): refresh always
        runs in the caller's thread."""
        timeout = self.attempt_timeout
        if not timeout:
            return fn()
        if self._attempt_pool is None:
            self._attempt_pool = cf.ThreadPoolExecutor(
                max_workers=4, thread_name_prefix="shard-attempt")
        fut = self._attempt_pool.submit(fn)
        try:
            return fut.result(timeout=timeout)
        except cf.TimeoutError:
            fut.cancel()
            self.health.note_timeout()
            obs.metrics.REGISTRY.counter("shard_timeout_total").inc()
            raise faultinject.ShardFailedError(
                None, f"{what} exceeded attempt_timeout={timeout}s "
                      f"(hung shard or collective)") from None

    # ---- coverage certification

    def _coverage(self):
        segs, _, _ = self._index_parts()
        ck = (tuple(id(si) for si, _ in segs), self.health.generation)
        if self._cov_cache is not None and self._cov_cache[0] == ck:
            return self._cov_cache[1]
        failed = self.health.failed
        total = covered = 0
        any_unc = False
        for si, _ in segs:
            sp = si.shard_packing(self.n_shards, self._bn,
                                  r=self.replication)
            owner = sp.owner_view(failed)
            pc = sp.partition_counts()
            total += int(pc.sum())
            covered += int(pc[owner >= 0].sum())
            any_unc = any_unc or bool(sp.uncovered_parts(owner).any())
        out = ((covered / total) if total else 1.0, any_unc)
        self._cov_cache = (ck, out)
        return out

    @property
    def coverage_degraded(self) -> bool:
        """True when some populated pivot group has no live replica:
        results then carry sound per-query recall bounds < 1 instead of
        the exactness guarantee."""
        if not self.health.failed:
            return False
        return self._coverage()[1]

    def coverage_fraction(self) -> float:
        """Share of the resident S rows in covered groups."""
        if not self.health.failed:
            return 1.0
        return self._coverage()[0]

    # ---- query API (failover-aware dispatch / finalize)

    def dispatch(self, queries: np.ndarray, *,
                 stats: Optional[JoinStats] = None) -> JoinHandle:
        """Validate → refresh (in the caller's thread) → enqueue →
        launch under ``attempt_timeout``; a ``ShardFault`` marks its
        shard failed and raises ``ShardFailedError``. ``stats`` is
        counted when the batch is finalized, so a failed-over batch
        counts once."""
        q = self._validated_queries(queries)
        n = q.shape[0]
        if stats is not None:
            stats.n_shards = self.n_shards
            stats.n_failed_shards = len(self.health.failed)
        if n == 0:
            return JoinHandle(kind="empty", n=0)
        try:
            payload = self.payload()
            qd, nv = self.enqueue(q)

            def launch():
                # a shard dying mid-stream, at launch
                faultinject.fire("sharded.shard_compute")
                return self._mega_call(payload, qd, nv)

            dev = self._bounded_attempt(launch, "sharded dispatch")
        except faultinject.ShardFault as e:
            raise self._shard_failed(e) from e
        meta = dict(n_segments=len(payload.segs),
                    n_tombstones=payload.dead_total,
                    pivots=sum(g.pivots_c.shape[0] for g in payload.segs))
        return JoinHandle(kind="sharded", n=n, dev=dev, meta=meta, q=q)

    def finalize(self, handle: JoinHandle, *,
                 stats: Optional[JoinStats] = None
                 ) -> tuple[np.ndarray, np.ndarray]:
        d, ids, _ = self.finalize_covered(handle, stats=stats)
        return d, ids

    def finalize_covered(self, handle: JoinHandle, *,
                         stats: Optional[JoinStats] = None):
        """:meth:`finalize` plus the per-query certified recall bound
        ``rb`` ((n,) float32, 1.0 on a fully served mesh): reported
        neighbour j of query q is provably in the global top-k iff
        ``d_j <= lm_q``, so at least ``rb·k`` of the k are true kNN."""
        k = self.config.k
        if handle.kind == "empty":
            return (np.zeros((0, k), np.float32),
                    np.full((0, k), -1, np.int64),
                    np.ones((0,), np.float32))
        if handle.kind != "sharded":
            raise ValueError(f"cannot finalize handle kind {handle.kind!r}")
        n = handle.n

        def fetch():
            faultinject.fire("megastep.fetch")     # a lost fetch
            dd, ii, lmv, unc = handle.dev
            # over the merged result: a fail is a poisoned gather, a
            # sleeping transform a hung one (bounded by attempt_timeout)
            dd = faultinject.cross("sharded.collective", dd)
            return tuple(x[:n].cpu().numpy() for x in (dd, ii, lmv, unc))

        try:
            with obs.span("sharded.collective", rows=n,
                          n_shards=self.n_shards,
                          generation=self.health.generation,
                          n_failed=len(self.health.failed)) as sp:
                d, ids, lm, unc = self._bounded_attempt(fetch,
                                                        "sharded finalize")
                sp.set(outcome="merged")
        except faultinject.ShardFault as e:
            raise self._shard_failed(e) from e
        self._rerun(handle, d, ids, unc, stats)
        with np.errstate(invalid="ignore"):
            rb = ((d <= lm[:, None]).sum(axis=1) / k).astype(np.float32)
        if stats is not None:
            meta = handle.meta or {}
            stats.n_r += n
            stats.n_s = max(stats.n_s, self.index.n_s)
            stats.n_segments = meta.get("n_segments", stats.n_segments)
            stats.n_tombstones = meta.get("n_tombstones", stats.n_tombstones)
            stats.pivot_pairs_computed += n * meta.get("pivots", 0)
            if self.coverage_degraded:
                stats.n_degraded += n
                stats.recall_bound = min(stats.recall_bound,
                                         float(rb.min()))
                stats.coverage_bound = min(stats.coverage_bound,
                                           self.coverage_fraction())
        return np.ascontiguousarray(d), np.ascontiguousarray(ids), rb

    def join_batch(self, queries: np.ndarray, *,
                   stats: Optional[JoinStats] = None
                   ) -> tuple[np.ndarray, np.ndarray]:
        d, ids, _ = self.join_batch_covered(queries, stats=stats)
        return d, ids

    def join_batch_covered(self, queries: np.ndarray, *,
                           stats: Optional[JoinStats] = None):
        """:meth:`join_batch` plus per-query certified recall bounds,
        with bounded internal failover: a ``ShardFailedError`` re-enters
        on the updated owner view, at most once per shard (the serving
        scheduler catches the error itself, to re-check deadlines)."""
        last = None
        for _ in range(self.n_shards + 1):
            try:
                return self.finalize_covered(
                    self.dispatch(queries, stats=stats), stats=stats)
            except faultinject.ShardFailedError as e:
                last = e
        raise last

    # ---- background recovery

    def recover(self, *, wait: bool = True):
        """Re-admit failed shards: rebuild and re-upload the whole
        shard-partitioned payload, swap it in under ``refresh_lock`` and
        reset health — serving keeps answering on the degraded view
        while the upload runs. ``wait=False`` returns the daemon thread
        doing the work."""
        if wait:
            self._recover_work()
            return None
        t = threading.Thread(target=self._recover_work,
                             name="shard-recover", daemon=True)
        t.start()
        return t

    def _recover_work(self) -> None:
        with self._recover_lock:
            if not self.health.failed:
                return
            with self.refresh_lock:
                segs, _, _ = self._index_parts()
            if not segs:
                with self.refresh_lock:
                    self.health.reset()
                    self._payload = None
                    self._cov_cache = None
                return
            # the expensive half — re-uploading every shard's slice —
            # runs outside refresh_lock so serving never blocks on it
            with obs.span("sharded.recover", n_shards=self.n_shards,
                          n_failed=len(self.health.failed)):
                st = self._build_struct(segs)
                skey = (tuple(id(si) for si, _ in segs), self._bn,
                        self.config.k)
                with self.refresh_lock:
                    self._struct = (skey, st)
                    self.health.reset()
                    self._payload = None
                    self._cov_cache = None
            reg = obs.metrics.REGISTRY
            reg.counter("shard_recover_total").inc()
            reg.gauge("shard_failed").set(0)
            reg.gauge("shard_generation").set(self.health.generation)
