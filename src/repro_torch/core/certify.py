"""Certified selection over K-G's float32 runs (ROADMAP C15 and C17).

K-G (``kernels.distance_topk``) selects each query's kp-run in float32
on centered rows, d² = ‖q‖² + ‖s‖² − 2q·s. Its rounding error grows
with the rows' spread: on map coordinates (OSM-like rows) it exceeds the
gap between a query's k-th and (k+1)-th neighbours, and where two rows
tie, which one the run keeps depends on how the kernel orders its
products (the card's K-G and its plain version differ there). So no
K-G route takes its k from K-G's order. Every one ends here:

* :func:`exact_d2` — a row's squared distance to the query in float64,
  Σ_t (q_t − s_t)² as an unrolled left-to-right chain of elementwise
  ops (float32 inputs, so every difference and square is exact; the
  same bits on every device).
* :func:`select_run` — from a query's run: the k rows first in
  (``exact_d2``, global id) order, reported as canonical distances in
  (canonical distance, id) order, and whether the run is *certified*:
  every row outside it has float32 d² at least the run's last value, so
  its ``exact_d2`` exceeds the k-th one when that value, less K-G's
  rounding bound, does. Rows farther from the center than ‖q_c‖ + the
  k-th distance are past it anyway, so the bound needs only the query's
  norm: (2d + 8)·2⁻²⁴·(2‖q_c‖ + √x_k)² (twice the error of the float32
  expansion, its centering and its √ included).
* :func:`exact_topk` — the same order over a set of live rows, for the
  queries whose run is not certified (their re-run; no kernel). The
  routes hand it a sound superset of each query's neighbours: the rows
  of its R tile's scheduled tiles (``megastep.rerun_scheduled``) or of
  its reducer group's replicas (``api.execute_join``).

A certified run and a re-run both give the k first live rows in
(``exact_d2``, id) order, so a route's result depends only on the
query and the live rows: the same ids on the card and on the CPU, on
one device and sharded, at ties too. On integer rows (Forest-like)
float32 d² gaps are ≥ 1 and the certificate passes wherever the run's
last value lies clear of the k-th.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .metrics import canonical_gathered

__all__ = ["exact_d2", "lex_order", "run_width", "select_run",
           "exact_topk", "f32_error_factor"]

# distances an exact re-run holds at once (float64: 128 MB)
_RERUN_ELEMS = 1 << 24
# extra rows the re-run's first top-k takes to see a tie group whole
_TIE_SLACK = 64


def run_width(k: int) -> int:
    """The run a certified route asks K-G for: the next power of two
    past k, so the run always holds a row beyond the k-th."""
    return 1 << int(k).bit_length()


def f32_error_factor(dim: int) -> float:
    """γ of the certificate: twice (d + 4) units of float32 roundoff."""
    return (2 * dim + 8) * 2.0 ** -24


def exact_d2(q: torch.Tensor, neigh: torch.Tensor) -> torch.Tensor:
    """``q`` (n, dim) against ``neigh`` (n, m, dim) or (m, dim): float64
    (n, m), one left-to-right chain per pair."""
    nn = neigh.to(torch.float64)
    if nn.dim() == 2:
        nn = nn[None]
    t = q.to(torch.float64)[:, None, :] - nn
    t = t * t                      # exact: float32 inputs
    acc = t[..., 0]
    for j in range(1, q.shape[1]):
        acc = acc + t[..., j]
    return acc


def lex_order(key: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Column order of each row by (key, id): two stable sorts."""
    o1 = torch.argsort(ids, dim=1, stable=True)
    o2 = torch.argsort(torch.take_along_dim(key, o1, dim=1), dim=1,
                       stable=True)
    return torch.take_along_dim(o1, o2, dim=1)


def select_run(f_run: torch.Tensor, x: torch.Tensor, ids: torch.Tensor,
               d_can: torch.Tensor, q_norm: torch.Tensor, k: int,
               dim: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The k of a run and its certificate, on the device (no host sync).

    ``f_run`` (n, kp) K-G's ascending √d² (float32; +inf on empty slots),
    ``x`` the rows' :func:`exact_d2`, ``ids`` their global ids (−1 on
    empty slots), ``d_can`` their canonical distances (all +inf / −1 on
    empty slots), ``q_norm`` (n,) float64 ‖q_c‖ of the centered query
    K-G saw. Returns ``(d (n, k) float32, ids (n, k) int64, uncertified
    (n,) bool)``."""
    o = lex_order(x, ids)[:, :k]
    xk = torch.take_along_dim(x, o, dim=1)[:, k - 1]
    ids_k = torch.take_along_dim(ids, o, dim=1)
    d_k = torch.take_along_dim(d_can, o, dim=1)
    last = f_run[:, -1].to(torch.float64)
    f_lo = last * last * (1.0 - 2.0 ** -21)
    err = f32_error_factor(dim) * torch.square(
        2.0 * q_norm + torch.sqrt(xk))
    cert = torch.isinf(last) | (f_lo - err > xk * (1.0 + 2.0 ** -40))
    o2 = lex_order(d_k, ids_k)
    return (torch.take_along_dim(d_k, o2, dim=1),
            torch.take_along_dim(ids_k, o2, dim=1), ~cert)


def exact_topk(q: torch.Tensor, rows: torch.Tensor, gids: torch.Tensor,
               k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k first of ``rows`` (global ids ``gids``, every one live) per
    query in (:func:`exact_d2`, id) order, as canonical distances in
    (canonical distance, id) order: ``(d (n, k) float32, ids (n, k)
    int64)``, (+inf, −1) past the live rows. On ``rows``' device."""
    dev = rows.device
    n, big = q.shape[0], rows.shape[0]
    order = torch.argsort(gids)
    rows, gids = rows[order], gids[order]
    q = q.to(device=dev, dtype=torch.float32)
    kk = min(k, big)
    out_d = torch.full((n, k), float("inf"), device=dev)
    out_i = torch.full((n, k), -1, dtype=torch.int64, device=dev)
    if n == 0 or kk == 0:
        return out_d, out_i
    step = max(1, _RERUN_ELEMS // big)
    for lo in range(0, n, step):
        qc = q[lo:lo + step]
        x = exact_d2(qc, rows)                                # (b, big)
        m = min(big, kk + _TIE_SLACK)
        vals, idx = torch.topk(x, m, dim=1, largest=False, sorted=True)
        o = lex_order(vals, idx)          # rows are id-ascending
        vals = torch.take_along_dim(vals, o, dim=1)
        idx = torch.take_along_dim(idx, o, dim=1)
        whole = (vals[:, m - 1] > vals[:, kk - 1]) | (m == big)
        sel = idx[:, :kk]
        if not bool(whole.all()):         # a tie group past the slack
            bad = ~whole
            sel[bad] = torch.argsort(x[bad], dim=1, stable=True)[:, :kk]
        d = canonical_gathered(qc, rows[sel])
        ids = gids[sel]
        o2 = lex_order(d, ids)
        out_d[lo:lo + step, :kk] = torch.take_along_dim(d, o2, dim=1)
        out_i[lo:lo + step, :kk] = torch.take_along_dim(ids, o2, dim=1)
    return out_d, out_i
