"""Two-tier quantized query engine: int8 coarse scan → exact fp32
re-rank, bitwise the fp32 oracle's distances — PyTorch port of the JAX
package's ``quant.engine`` (single device, static ``SIndex``).

Per batch:

1. **plan** — stages 1–3 of the fp32 megastep
   (``core.megastep.assign_bounds_schedule``): assignment, θ and the
   compacted Cor. 1 / Thm 2 tile schedule, on exact pivot geometry.
2. **coarse int8 scan** — the queries are quantized in the step
   (:func:`quantize_queries`) and ``kernels.ops.quant_coarse_topk``
   (the CUDA kernel K-Q on the card, its plain version on the CPU)
   keeps, over the scheduled tiles only, the ``mp`` smallest certified
   lower bounds ``lb = max(d_coarse − ε_total, 0)`` with ``lb ≤ θ`` —
   θ effectively inflated by ε, so a true neighbor is never pruned.
3. **exact re-rank** — the shortlisted rows' canonical fp32 distances
   (``metrics.canonical_gathered``), stable-sorted, first k: either
   **resident** (fp32 rows on the device beside the codes, the re-rank
   fused into the step, no host sync) or **host-gather** (the rows stay
   on the host and the shortlist round-trips through
   ``metrics.canonical_topk``).
4. **certification** — with L = the shortlist's largest lb (+inf if it
   was not filled) and τ̂ = the k-th exact distance, every excluded row
   has lb ≥ L, so ``L ≥ τ̂`` proves the result. Queries that fail re-run
   through the fp32 host-planned path (``MutableIndex.join_batch`` over
   segments; ``JoinStats.n_quant_fallback`` counts them): exactness is
   unconditional.

Construction resolves ``mode`` (``"int8"``, or ``"fp32"`` when a tuning
table entry measured int8 as a loss; an explicit slack pins int8),
``mp`` (explicit slack, else the tuned value, else max(pow2(4k), 128))
and ``resident`` (fits ``REPRO_QUANT_RESIDENT_MAX_BYTES``, default
1 GiB). The port's tuning table (``quant.autotune``) holds the card's
cells, measured by ``tools/tune_quant.py``; a shape without a cell on its
backend (every CPU shape) runs int8.

``ShardedQuantMegastepEngine`` runs the same tier over a mesh
(``core.sharded``): K-Q on each shard's codes, ε and schedule, the exact
re-rank on the shard, the id-disjoint tree merge of the runs and the
minimum of the shards' certification bounds.

Soundness (the ε lemma): with ŝ = code·scale and q̂ the quantized query,
|d(q̂, ŝ) − d(q, s)| ≤ ε_q + ε_s, and ε_num dominates the float32
rounding of d(q̂, ŝ) itself (``kernels.quant_topk``).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional, Union

import numpy as np
import torch

from .. import obs
from ..core.bounds import pad_theta
from ..core.megastep import (JoinHandle, MegastepEngine, StepOut, _Payload,
                             assign_bounds_schedule, canonical_run,
                             schedule_visits)
from ..core.metrics import canonical_gathered, canonical_topk
from ..core.sharded import (_per_device, _sharded_megastep,
                            _ShardedPayloadMixin)
from ..core.types import JoinConfig, JoinStats
from ..kernels import ops
from ..kernels.sorted_merge import next_pow2, tree_merge_runs
from ..serve import faultinject
from . import autotune
from .autotune import TunedConfig
from .quantize import resident_extra_bytes

__all__ = ["QuantMegastepEngine", "ShardedQuantMegastepEngine",
           "quantize_queries"]

# resident re-rank auto-threshold: keep the fp32 rows + ids on the device
# only while they fit comfortably
_RESIDENT_MAX_BYTES = int(os.environ.get(
    "REPRO_QUANT_RESIDENT_MAX_BYTES", 1 << 30))

_EPS_REL = float(np.float32(1.0 + 1e-5))
_EPS_ABS = float(np.float32(1e-7))


def quantize_queries(q: torch.Tensor):
    """Per-row symmetric int8 query quantization, in the step: returns
    ``(codes int8, scales f32, eps f32)`` with eps an upper bound on
    ‖q − q̂‖₂ — the float32 norm (an unrolled left-to-right sum and a
    correctly rounded √, the same bits on every device) inflated by a
    relative + absolute margin that dwarfs its own rounding."""
    amax = q.abs().amax(dim=1)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    codes = torch.clamp(torch.round(q / scale[:, None]), -127, 127)
    diff = q - codes * scale[:, None]
    acc = diff[:, 0] * diff[:, 0]
    for t in range(1, q.shape[1]):
        acc = acc + diff[:, t] * diff[:, t]
    err = torch.sqrt(acc.to(torch.float64)).to(torch.float32)
    return codes.to(torch.int8), scale, err * _EPS_REL + _EPS_ABS


@dataclasses.dataclass
class _QuantPayload(_Payload):
    """The megastep payload plus the int8 twin of the packed rows."""

    sq: torch.Tensor                     # (ns_tiles·bn, dim) int8 codes
    sscale: torch.Tensor                 # (ns_tiles,) float32
    seps: torch.Tensor                   # (ns_tiles·bn,) float16 ε_s
    rows_host: Optional[torch.Tensor]    # host-gather: padded fp32 rows
    gids_host: torch.Tensor              # (ns_tiles·bn,) int64 on the CPU


def _quant_coarse(q, n_valid, pl: _QuantPayload, *, mp, k, bm, bn):
    """Stages 1–3 of the megastep → in-step query quantization → the
    int8 coarse shortlist. Returns ``(lb (B, mp), pos (B, mp) int32)``
    in the original query order; empty slots are (+inf, -1). θ is
    ulp-padded like every prune site: the certified lb can equal the
    true distance, and θ's float value may round below the Thm-3
    bound."""
    qs, _, inv, th_q, sched, cnt = assign_bounds_schedule(q, n_valid, pl,
                                                          k=k, bm=bm)
    qi, qscale, qeps = quantize_queries(qs)
    lb, pos = ops.quant_coarse_topk(
        qi, qscale, qeps, pad_theta(th_q).contiguous(), pl.sq, pl.sscale,
        pl.seps, pl.alive, mp, sched, cnt, bm=bm, bn=bn)
    return lb[inv], pos[inv]


def _quant_megastep(q, n_valid, pl: _QuantPayload, *, mp, k, bm, bn):
    """The fused resident step: coarse shortlist → on-device fp32 gather
    → canonical exact re-rank (stage 5 of the fp32 megastep). Returns a
    device ``StepOut`` with ``lm`` the per-query exclusion bound (the
    shortlist's largest lb) and nothing uncertified."""
    lb, pos = _quant_coarse(q, n_valid, pl, mp=mp, k=k, bm=bm, bn=bn)
    # pos ≥ 0 ⇔ a live row: the coarse pass masks dead and padding rows
    valid = pos >= 0
    pos_c = torch.clamp(pos.to(torch.int64), 0, pl.s.shape[0] - 1)
    d_can = torch.where(valid, canonical_gathered(q, pl.s[pos_c]),
                        float("inf"))
    ids = torch.where(valid, pl.gids[pos_c], -1)
    d_can, order = torch.sort(d_can, dim=1, stable=True)
    ids = torch.take_along_dim(ids, order, dim=1)
    return _int8_out(d_can[:, :k], ids[:, :k], lb[:, -1])


def _int8_out(d, ids, lm) -> StepOut:
    """An int8 step's ``StepOut``: certified by ``lm``, none by K-G."""
    return StepOut(d, ids, lm, torch.zeros((d.shape[0],), dtype=torch.bool,
                                           device=d.device))


class QuantMegastepEngine(MegastepEngine):
    """Memory-lean drop-in for ``MegastepEngine`` over an ``SIndex`` or
    a ``MutableIndex`` (live tombstones included): the same exact
    results from an int8-resident coarse pass. Reached via
    ``knn_join(..., quantized=True)``, ``knn_join_batched(...,
    quantized=True)`` and ``StreamJoinEngine(..., quantized=True)``.
    L2 only.

    ``slack`` (default ``config.quant_slack``; ≥ 0 pins int8 with
    ``mp = pow2(k + slack)``), ``resident`` (None = auto-size),
    ``tune`` (``"auto"`` looks the shape up in the tuning table, a
    ``TunedConfig`` is used as given, anything else skips the table),
    ``tune_bn`` (S-tile rows override).
    """

    def __init__(self, index, config: Optional[JoinConfig] = None, *,
                 slack: Optional[int] = None, bucket_min: int = 16,
                 resident: Optional[bool] = None, tune="auto",
                 tune_bn: Optional[int] = None,
                 device: Union[str, torch.device] = "cuda"):
        cfg = config or index.config
        if cfg.metric != "l2":
            raise ValueError(
                f"the quantized tier supports metric='l2' only, got "
                f"{cfg.metric!r}; use the fp32 host engines")
        super().__init__(index, config, bucket_min=bucket_min,
                         device=device)
        k = self.config.k
        if slack is None:
            slack = self.config.quant_slack
        explicit = slack is not None and slack >= 0

        # ---- tuning-table lookup (measured mode / mp / tile shapes)
        tuned: Optional[TunedConfig] = None
        if isinstance(tune, TunedConfig):
            tuned = tune
        elif tune == "auto" and not explicit:
            tuned = autotune.lookup(index.dim, index.n_s, k,
                                    self.device.type)
        self.tuned = tuned
        self.autotuned = tuned is not None
        self.mode = ("fp32" if tuned is not None and tuned.mode == "fp32"
                     and not explicit else "int8")
        if explicit:
            self.mp = next_pow2(max(k + int(slack), k, 1))
        elif tuned is not None and tuned.mp:
            self.mp = max(next_pow2(tuned.mp), next_pow2(k))
        else:
            # certification needs the shortlist boundary to clear the
            # k-th neighbor by ~2·(ε_s + ε_q): a rank gap of ~10×k
            self.mp = max(next_pow2(4 * k), 128)
        if tune_bn:
            self._bn = int(tune_bn)
        elif self.mode == "int8" and tuned is not None and tuned.bn:
            self._bn = int(tuned.bn)
        if self.mode == "int8" and tuned is not None and tuned.bm:
            self._bm_cap = int(tuned.bm)
        if self.mode == "fp32":
            self.resident = False      # the plain megastep
        elif resident is not None:
            self.resident = bool(resident)
        else:
            self.resident = (resident_extra_bytes(index.n_s, index.dim)
                             <= _RESIDENT_MAX_BYTES)
        self._rows_on_device = self.mode == "fp32" or self.resident

    # ---- device payload: int8 codes + scales + ε per segment,
    # concatenated like the fp32 tiles (+ fp32 rows when the re-rank is
    # resident)

    def _build_struct(self, segs) -> dict:
        st = super()._build_struct(segs)
        if self.mode == "fp32":
            return st
        dev = self.device
        qrs = [si.ensure_quant(self._bn) for si, _ in segs]
        st.update(
            sq=torch.as_tensor(np.concatenate([qr.q for qr in qrs]),
                               device=dev),
            sscale=torch.as_tensor(np.concatenate([qr.scales for qr in qrs]),
                                   device=dev),
            seps=torch.as_tensor(np.concatenate([qr.eps for qr in qrs]),
                                 device=dev),
            rows_host=None if self.resident else st["rows"].cpu(),
            gids_host=st["gids"].cpu())
        return st

    def _make_payload(self, st: dict, alive: torch.Tensor,
                      dead_total: int) -> _Payload:
        base = super()._make_payload(st, alive, dead_total)
        if self.mode == "fp32":
            return base
        return _QuantPayload(
            **{f.name: getattr(base, f.name)
               for f in dataclasses.fields(_Payload)},
            sq=st["sq"], sscale=st["sscale"], seps=st["seps"],
            rows_host=st["rows_host"], gids_host=st["gids_host"])

    def _step_args(self, q_dev: torch.Tensor) -> dict:
        bucket = int(q_dev.shape[0])
        return dict(mp=self.mp, k=self.config.k,
                    bm=min(bucket, self._bm_cap), bn=self._bn)

    # ---- two-tier query path

    def coarse_shortlist(self, queries: np.ndarray):
        """The int8 pass alone: numpy ``(lb, pos, ids)`` for one batch —
        ascending certified lower bounds, packed-row positions and their
        global ids (−1 on empty slots)."""
        if self.mode == "fp32":
            raise RuntimeError(
                "this engine was tuned to mode='fp32' — there is no coarse "
                "pass; force int8 with an explicit slack=")
        q = self._validated_queries(queries)
        n = q.shape[0]
        qd, nv = self.enqueue(q)
        pl = self.payload()
        with obs.span("quant.coarse", rows=n, mp=self.mp, mode=self.mode):
            lb, pos = _quant_coarse(qd, nv, pl, **self._step_args(qd))
            faultinject.fire("megastep.fetch")     # a lost fetch
            lb = lb[:n].cpu().numpy()
            pos = pos[:n].cpu().numpy()
        # deflating the certified bounds is what inflated ε would do
        lb = faultinject.transform_value("quant.eps_inflation", lb)
        gids = pl.gids_host.numpy()
        ids = np.where(pos >= 0, gids[np.clip(pos, 0, gids.shape[0] - 1)],
                       -1)
        return lb, pos, ids

    def join_batch_device(self, q_dev, n_valid: int, *, state=None):
        """Resident mode's steady-state call: a device ``StepOut`` of one
        fused step, no host sync (``lm`` the certification bound). fp32
        mode delegates to the parent. The host-gather variant has no
        device-only form."""
        if self.mode == "fp32":
            return super().join_batch_device(q_dev, n_valid, state=state)
        if not self.resident:
            raise NotImplementedError(
                "the host-gather quantized variant re-ranks on the host; "
                "use join_batch, or resident=True for the fused device "
                "path")
        if state is not None:
            raise NotImplementedError(
                "carried-state merge is the fp32 megastep's API; the quant "
                "megastep emits a fresh certified run per batch")
        pl = self.payload()
        kw = self._step_args(q_dev)
        with obs.span("quant.device_step", bucket=int(q_dev.shape[0]),
                      bm=kw["bm"], bn=kw["bn"], mp=self.mp) as sp:
            out = _quant_megastep(q_dev, n_valid, pl, **kw)
            sp.set(outcome="launched")
        self.step_count += 1
        return out

    def dispatch(self, queries: np.ndarray, *,
                 stats: Optional[JoinStats] = None) -> JoinHandle:
        q = self._validated_queries(queries)
        n = q.shape[0]
        if stats is not None:
            stats.quant_mode = self.mode
            stats.quant_mp = self.mp if self.mode == "int8" else 0
            stats.quant_autotuned = self.tuned is not None
        if self.mode == "fp32":
            return super().dispatch(q, stats=stats)
        if n == 0:
            return JoinHandle(kind="empty", n=0)
        pl = self.payload()
        if stats is not None:
            self._count(stats, n, pl)
        qd, nv = self.enqueue(q)
        if self.resident:
            return JoinHandle(kind="quant_resident", n=n,
                              dev=self.join_batch_device(qd, nv), q=q)
        lb, pos = _quant_coarse(qd, nv, pl, **self._step_args(qd))
        self.step_count += 1
        return JoinHandle(kind="quant_host", n=n, dev=(lb, pos), q=q)

    def finalize(self, handle: JoinHandle, *,
                 stats: Optional[JoinStats] = None
                 ) -> tuple[np.ndarray, np.ndarray]:
        if handle.kind in ("empty", "mega"):
            return super().finalize(handle, stats=stats)
        k = self.config.k
        d, ids, lm = self._fetch_shortlist_run(handle, stats)
        # certification: excluded coarse candidates all carry lb ≥ the
        # run's largest slot (+inf: nothing was excluded); τ̂ is the
        # exact reported k-th distance
        bad = ~(lm >= d[:, k - 1])           # NaN-safe: fail on weirdness
        if bad.any():
            n_bad = int(bad.sum())
            with obs.span("quant.fallback", rows=n_bad, mode=self.mode,
                          mp=self.mp):
                d[bad], ids[bad] = self._oracle_join(handle.q[bad])
            obs.metrics.REGISTRY.counter("quant_fallback_total").inc(n_bad)
            if stats is not None:
                stats.n_quant_fallback += n_bad
        return np.ascontiguousarray(d), np.ascontiguousarray(ids)

    def _fetch_shortlist_run(self, handle: JoinHandle, stats):
        """Fetch a dispatched two-tier batch through its re-rank variant:
        numpy ``(d, ids, lm)``, counted as a resident or host re-rank."""
        if handle.kind == "quant_resident":
            out = self._fetch_resident(handle)
            if stats is not None:
                stats.n_resident_rerank += handle.n
        elif handle.kind == "quant_host":
            out = self._finalize_host_shortlist(handle)
            if stats is not None:
                stats.n_host_rerank += handle.n
        else:
            raise ValueError(f"cannot finalize handle kind {handle.kind!r}")
        return out

    def _fetch_resident(self, handle: JoinHandle):
        """Fetch a fused resident batch: numpy ``(d, ids, lm)`` — the
        exact top-k and the per-query exclusion bound."""
        faultinject.fire("megastep.fetch")     # a lost fetch
        out = handle.dev
        d, ids, lm = (x[:handle.n].cpu().numpy()
                      for x in (out.d, out.ids, out.lm))
        # deflated bounds force certification failures downstream
        lm = faultinject.transform_value("quant.eps_inflation", lm)
        return d, ids, lm

    def _finalize_host_shortlist(self, handle: JoinHandle):
        """Host half of the host-gather variant: fetch the shortlist,
        gather the fp32 rows on the host, canonical re-rank. Returns
        numpy ``(d, ids, lm)``."""
        n, k = handle.n, self.config.k
        pl = self.payload()
        faultinject.fire("megastep.fetch")         # a lost fetch
        lb = torch.from_numpy(faultinject.transform_value(
            "quant.eps_inflation", handle.dev[0][:n].cpu().numpy()))
        pos = handle.dev[1][:n].cpu().to(torch.int64)
        pos_c = torch.clamp(pos, 0, pl.gids_host.shape[0] - 1)
        ids = torch.where(pos >= 0, pl.gids_host[pos_c], -1)
        d, ids = canonical_topk(torch.from_numpy(handle.q), ids,
                                pl.rows_host[pos_c])
        return d[:, :k].numpy(), ids[:, :k].numpy(), lb[:, -1].numpy()

    def join_batch_approx(
        self, queries: np.ndarray, *, stats: Optional[JoinStats] = None,
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Coarse-only certified-*approximate* join — the serving
        scheduler's degraded rung. The same coarse shortlist and exact
        re-rank as :meth:`join_batch`, but certification failures are
        **not** re-run through the fp32 host path; every query reports a
        *certified recall lower bound* instead.

        Returns ``(dists, ids, recall_bound)`` with ``recall_bound[i] =
        #{j : dists[i, j] ≤ lm_i} / k``, where ``lm_i`` bounds every
        excluded row's true distance from below. A reported neighbour
        with distance ≤ lm has global rank ≤ its shortlist rank ≤ k, so
        it provably belongs to the true top-k: the bound counts only
        such neighbours and is sound, never optimistic. An unfilled
        shortlist (lm = +inf) excluded nothing: the result is exact and
        the bound is 1. Reported distances are always exact (the re-rank
        is the canonical fp32 chain); only membership of the true top-k
        is approximate. In fp32 mode there is no shortlist: the exact
        scan runs and the bound is 1.
        """
        q = self._validated_queries(queries)
        n = q.shape[0]
        k = self.config.k
        if n == 0:
            return (np.zeros((0, k), np.float32),
                    np.full((0, k), -1, np.int64),
                    np.ones((0,), np.float32))
        if self.mode == "fp32":
            out_d, out_i = self.join_batch(q, stats=stats)
            recall = np.ones((n,), np.float32)
        else:
            handle = self.dispatch(q, stats=stats)
            out_d, out_i, lm = self._fetch_shortlist_run(handle, stats)
            with np.errstate(invalid="ignore"):
                proven = out_d <= lm[:, None]      # NaN-safe: counts False
            recall = proven.sum(axis=1).astype(np.float32) / np.float32(k)
        if stats is not None:
            stats.n_degraded += n
            stats.recall_bound = min(stats.recall_bound,
                                     float(recall.min()))
        return out_d, out_i, recall

    def _oracle_join(self, q: np.ndarray):
        """The fp32 host-planned path for certification failures — it
        reports through the same canonical chain, so patched rows are
        what a full oracle run would emit."""
        from ..core.api import execute_join
        from ..core.index import plan_queries
        from ..core.segments import MutableIndex
        if isinstance(self.index, MutableIndex):
            return self.index.join_batch(q, config=self.config)
        return execute_join(q, self.index,
                            plan_queries(q, self.index, self.config))


# ---------------------------------------------------------------------------
# the sharded quantized engine (core.sharded holds the fp32 twin)


def _sharded_quant_megastep(q, n_valid, pl, *, mp, k, bm, bn, devices):
    """``_quant_megastep`` over every shard: the int8 shortlist against
    the shard's codes, ε and compacted schedule, the exact re-rank on the
    shard (kept kp wide), the runs gathered to ``q``'s device and
    tree-merged, and the certification bound the minimum over shards.
    Sound: a row shard j left out of its shortlist has lb ≥ lm_j ≥ min_j
    lm_j; a shortlisted row dropped past rank kp is no nearer than the
    shard's kp-th ≥ the merged k-th. Returns a device ``StepOut``."""
    kp = next_pow2(k)
    home = q.device
    pre = _per_device(q, pl, devices, n_valid, k)
    qz = {}
    runs, lm = [], None
    for sp, dev in zip(pl.shards, devices):
        _, (qs, qcs, valid_s, inv, th_q, qps, homes) = pre[str(dev)]
        if str(dev) not in qz:
            qz[str(dev)] = quantize_queries(qs) + (
                pad_theta(th_q).contiguous(),)
        qi, qscale, qeps, theta = qz[str(dev)]
        sched, cnt = schedule_visits(qps, homes, th_q, valid_s, sp.segs,
                                     bm=bm)
        lb, pos = ops.quant_coarse_topk(
            qi, qscale, qeps, theta, sp.sq, sp.sscale, sp.seps, sp.alive,
            mp, sched, cnt, bm=bm, bn=bn)
        d, ids = canonical_run(qs, sp, pos)
        runs.append((d[:, :kp][inv].to(home, non_blocking=True),
                     ids[:, :kp][inv].to(home, non_blocking=True)))
        lm_j = lb[:, -1][inv].to(home, non_blocking=True)
        lm = lm_j if lm is None else torch.minimum(lm, lm_j)
    d, ids = runs[0] if len(runs) == 1 else tree_merge_runs(runs)
    return _int8_out(d[:, :k], ids[:, :k], lm)


class ShardedQuantMegastepEngine(_ShardedPayloadMixin,
                                 QuantMegastepEngine):
    """``QuantMegastepEngine`` over a 1-D "shard" mesh: int8 codes,
    ε and fp32 rows partitioned by ``SIndex.shard_packing``, the
    coarse scan and exact re-rank per shard, certification combined
    across shards. dispatch() / finalize(), the certification with
    its fp32 fallback and ``join_batch_approx`` are inherited; only
    the device call underneath is sharded.

    Residency is decided per shard (the largest shard's rows), and
    the sharded int8 tier requires it: the host-gather re-rank is a
    host round trip by construction. No replication (its HBM budget
    is the point of int8)."""

    def __init__(self, index, config: Optional[JoinConfig] = None, *,
                 n_shards: Optional[int] = None, mesh=None,
                 slack: Optional[int] = None, bucket_min: int = 16,
                 resident: Optional[bool] = None, tune="auto",
                 tune_bn: Optional[int] = None, device=None):
        self._init_mesh(n_shards, mesh, device)
        QuantMegastepEngine.__init__(
            self, index, config, slack=slack, bucket_min=bucket_min,
            resident=resident, tune=tune, tune_bn=tune_bn,
            device=index.device)
        if self.mode == "int8" and resident is None:
            self.resident = (resident_extra_bytes(
                self._resident_fit_rows(), index.dim)
                <= _RESIDENT_MAX_BYTES)
        if self.mode == "int8" and not self.resident:
            raise ValueError(
                f"the sharded int8 engine is resident-only, but the "
                f"largest shard ({self._resident_fit_rows()} rows) "
                f"exceeds REPRO_QUANT_RESIDENT_MAX_BYTES "
                f"({_RESIDENT_MAX_BYTES}); add shards, raise the cap, "
                f"or use the single-device QuantMegastepEngine")
        self._place(index)

    def _resident_fit_rows(self) -> int:
        segs, _, _ = self._index_parts()
        per = np.zeros((self.n_shards,), np.int64)
        for si, _ in segs:
            per += si.shard_packing(self.n_shards,
                                    self._bn).rows_per_shard
        return int(per.max()) if per.size else 0

    def _build_struct(self, segs) -> dict:
        st = super()._build_struct(segs)
        if self.mode == "fp32":
            return st
        for j, sh in enumerate(st["shards"]):
            sq, sc, ep = (np.concatenate([x[j] for x in parts])
                          for parts in zip(*(sp.ensure_quant()
                                             for sp in st["packs"])))
            sh.update(sq=self._put_shard(sq, j),
                      sscale=self._put_shard(sc, j),
                      seps=self._put_shard(ep, j),
                      gids_host=torch.from_numpy(sh["gids_np"]))
        return st

    def _shard_payload(self, st, j, sh, segs, alive, dead_total):
        base = super()._shard_payload(st, j, sh, segs, alive,
                                      dead_total)
        if self.mode == "fp32":
            return base
        return _QuantPayload(
            **{f.name: getattr(base, f.name)
               for f in dataclasses.fields(_Payload)},
            sq=sh["sq"], sscale=sh["sscale"], seps=sh["seps"],
            rows_host=None, gids_host=sh["gids_host"])

    def coarse_shortlist(self, queries: np.ndarray):
        raise NotImplementedError(
            "coarse_shortlist is the single-device debugging surface; "
            "the sharded coarse pass never leaves the mesh — use "
            "join_batch / join_batch_approx")

    def join_batch_device(self, q_dev, n_valid: int, *, state=None):
        """A device ``StepOut`` of one sharded step, no host sync (fp32
        mode: the sharded fp32 megastep's)."""
        bucket = int(q_dev.shape[0])
        bm = min(bucket, self._bm_cap)
        pl = self.payload()
        if self.mode == "fp32":
            out = _sharded_megastep(
                q_dev, n_valid, pl, k=self.config.k, bm=bm, bn=self._bn,
                devices=self.mesh.devices, state=state)
            self.step_count += 1
            return out
        if state is not None:
            raise NotImplementedError(
                "carried-state merge is the fp32 megastep's API; the "
                "quant megastep emits a fresh certified run per batch")
        with obs.span("quant.device_step", bucket=bucket, bm=bm,
                      bn=self._bn, mp=self.mp,
                      n_shards=self.n_shards) as sp:
            out = _sharded_quant_megastep(
                q_dev, n_valid, pl, mp=self.mp, k=self.config.k, bm=bm,
                bn=self._bn, devices=self.mesh.devices)
            sp.set(outcome="launched")
        self.step_count += 1
        return out
