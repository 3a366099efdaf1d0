"""Public entry points for the PGBJ kNN join — PyTorch port of the JAX
package's ``core.api``.

``knn_join`` composes the split planner: preprocessing (pivots from R,
the paper's prescription) → S-side phase 1 (``build_index``, or a
prebuilt ``index=``) → per-batch query planning (``plan_queries``) →
job 2 (``execute_join``: replicate + per-group join). ``megastep=True``
runs the batch through the fused device megastep instead, and
``quantized=True`` through the int8 two-tier engine; all three routes
report the same canonical distances.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from ..device import resolve_device
from .index import (QueryPlan, SIndex, as_float32_rows, build_index,
                    plan_queries)
from .certify import exact_topk
from .join import join_group
from .metrics import canonical_topk
from .types import JoinConfig, JoinResult, JoinStats

__all__ = ["knn_join", "JoinPlan", "plan_join", "execute_join"]


@dataclasses.dataclass
class JoinPlan:
    """One build-once ``SIndex`` + one per-batch ``QueryPlan``: what
    ``plan_join`` returns and ``knn_join(plan=...)`` reuses."""

    index: SIndex
    query: QueryPlan


def plan_join(r, s, config: JoinConfig, *,
              device: Union[str, torch.device] = "cuda") -> JoinPlan:
    """Preprocessing + job 1 + bounds and grouping, with pivots selected
    from R (the paper's prescription)."""
    r = as_float32_rows(r, what="R rows")
    index = build_index(s, config, pivot_data=r.cpu().numpy(),
                        device=device)
    return JoinPlan(index=index, query=plan_queries(r, index, config))


def execute_join(r, index: SIndex, qplan: QueryPlan, *,
                 stats: Optional[JoinStats] = None
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Job 2 over one query batch: per-group replicate + join against the
    resident index. Returns numpy (dists float32 (|R|, k), ids int64
    (|R|, k)) — global S row ids, true distances ascending, in the
    canonical chain, so a query's output does not depend on its batch."""
    cfg = qplan.config
    r = as_float32_rows(r, what="R rows").to(index.device)
    out_i = torch.full((r.shape[0], cfg.k), -1, dtype=torch.int64,
                       device=index.device)
    unc = torch.zeros((r.shape[0],), dtype=torch.bool, device=index.device)
    group_of_r = qplan.group_of_r()
    for g in range(qplan.n_groups):
        r_sel = torch.nonzero(group_of_r == g)[:, 0]
        if r_sel.numel() == 0:
            continue
        _, gi, gu = join_group(g, r, r_sel, index, qplan, stats=stats)
        out_i[r_sel] = gi
        if gu is not None:
            unc[r_sel] = gu
    if bool(unc.any()):
        # the gather reducer's uncertified K-G runs, re-run exactly over
        # their group's replicas (a sound superset of each query's kNN)
        for g in torch.unique(group_of_r[unc]).tolist():
            sel = torch.nonzero(unc & (group_of_r == g))[:, 0]
            mask = index.replica_mask_sorted(qplan.lb_group, g)
            _, out_i[sel] = exact_topk(r[sel], index.s_sorted[mask],
                                       index.s_ids_sorted[mask], cfg.k)
        if stats is not None:
            stats.n_exact_rerun += int(unc.sum())
    d, ids = canonical_topk(r, out_i, index.rows_for_ids(out_i), cfg.metric)
    return d.cpu().numpy(), ids.cpu().numpy()


def _check_s(s, index: SIndex, k: int) -> None:
    if s is not None and len(s) != index.n_s:
        raise ValueError(
            f"s has {len(s)} rows but the index holds {index.n_s}; results "
            f"would index the wrong dataset")
    if k > index.n_s:
        raise ValueError(f"k={k} > |S|={index.n_s}")


def _engine_cls(quantized: bool):
    if quantized:
        from ..quant.engine import QuantMegastepEngine
        return QuantMegastepEngine
    from .megastep import MegastepEngine
    return MegastepEngine


def knn_join(
    r, s=None, k: int | None = None, config: Optional[JoinConfig] = None,
    *, plan: Optional[JoinPlan] = None, index=None, megastep: bool = False,
    quantized: Optional[bool] = None,
    device: Union[str, torch.device] = "cuda",
) -> JoinResult:
    """PGBJ kNN join: for every row of ``r``, the k nearest rows of ``s``
    — global S row ids (int64) and true distances, ascending per query.

    ``index=`` joins against a prebuilt ``SIndex`` or a
    ``MutableIndex`` (S-side phase 1 is not re-run; ``s`` may be
    omitted; a mutable index fans the batch over every live segment);
    ``plan=`` also reuses a query plan. Otherwise the index is built
    from ``s`` on ``device`` with pivots selected from ``r`` — the
    paper's one-shot pipeline.
    ``megastep=True`` runs the fused device megastep (L2);
    ``quantized=True`` (default: on when ``config.quantize != "none"``)
    the int8 coarse scan + exact fp32 re-rank (L2). Every route reports
    the same canonical distances.
    """
    from .segments import MutableIndex

    if plan is not None:
        index = plan.index
    if index is not None:
        config = config or index.config
    config = config or JoinConfig(k=k or 10)
    if k is not None and k != config.k:
        config = dataclasses.replace(config, k=k)
    if quantized is None:
        quantized = config.quantize != "none"
    if (quantized or megastep) and plan is not None:
        raise ValueError(
            "megastep=True / quantized=True plan on the device and cannot "
            "reuse plan=; pass index= instead")
    r_np = as_float32_rows(r, what="R rows").cpu().numpy()
    if isinstance(index, MutableIndex):
        resolve_device(device)
        if s is not None and len(s) != index.n_s:
            raise ValueError(
                f"s has {len(s)} rows but the mutable index holds "
                f"{index.n_s} live; results would index the wrong dataset")
        if config.k > index.n_s:
            raise ValueError(f"k={config.k} > live |S|={index.n_s}")
        stats = JoinStats(n_s=index.n_s)
        if quantized or megastep:
            out_d, out_i = _engine_cls(quantized)(
                index, config, device=index.device).join_batch(
                    r_np, stats=stats)
        else:
            stats.n_r = r_np.shape[0]
            out_d, out_i = index.join_batch(r_np, config=config,
                                            stats=stats)
        return JoinResult(indices=out_i, distances=out_d, stats=stats)
    built_here = index is None
    if index is None:
        if s is None:
            raise ValueError("knn_join needs s= or a prebuilt plan/index")
        if config.k > len(s):
            raise ValueError(f"k={config.k} > |S|={len(s)}")
        index = build_index(s, config, pivot_data=r_np, device=device)
    else:
        resolve_device(device)
        _check_s(s, index, config.k)
    # the engine routes count their own queries (the JAX package's
    # megastep / quantized routes count them twice: ROADMAP Queue C4)
    stats = JoinStats(n_s=index.n_s)
    # job-1 mapper pivot distances count toward Eq. 13 (paper §6 note);
    # a reused index's S-side phase 1 was paid at build, not here
    if built_here:
        stats.pivot_pairs_computed += index.n_s * index.n_pivots
    if quantized or megastep:
        out_d, out_i = _engine_cls(quantized)(
            index, config, device=index.device).join_batch(r_np, stats=stats)
        return JoinResult(indices=out_i, distances=out_d, stats=stats)
    if plan is not None:
        qplan = plan.query
        if config is not qplan.config:
            # θ/LB computed for plan.k stay sound only for k at most
            # plan.k, and only in the metric they were derived for
            if config.k > qplan.config.k:
                raise ValueError(
                    f"k={config.k} > plan was built for k={qplan.config.k}; "
                    f"re-plan with plan_queries")
            if config.metric != qplan.config.metric:
                raise ValueError(
                    f"metric={config.metric!r} but the plan was built with "
                    f"{qplan.config.metric!r}")
            qplan = dataclasses.replace(qplan, config=config)
    else:
        qplan = plan_queries(r_np, index, config)
    stats.n_r = r_np.shape[0]
    stats.pivot_pairs_computed += r_np.shape[0] * index.n_pivots
    out_d, out_i = execute_join(r_np, index, qplan, stats=stats)
    return JoinResult(indices=out_i, distances=out_d, stats=stats)
