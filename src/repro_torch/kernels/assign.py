"""Nearest-pivot assignment (PGBJ phase-1 hot loop): the CUDA kernel
``csrc/assign.cu`` and its plain PyTorch version.

The kernel replaces the JAX package's Pallas ``assign_kernel``
(``kernels/assign.py:23``). It runs in one of two forms that
:func:`plan_assign` picks from the static shapes — *narrow* (d <= 32:
rows in registers, pivots in shared memory) or *tile* (an fp32 128 × 128
register tile with the argmin fused in) — and may cut the pivots into
ranges across blocks (splits) whose (d², id) minima fold in that order.
Both forms and every cut sum the same chain (‖x‖², ‖p‖² and x·p each one
fmaf chain over ascending j, d² = max((‖x‖²+‖p‖²) − 2x·p, 0), √ last),
so they give the same bits, and so does the dense top-k kernel at k = 1,
which sums that chain too.

The plain version is the arithmetic of the JAX package's
``partition._assign_blocked`` — ‖x‖²+‖p‖²−2x·pᵀ with ``torch.matmul``,
clamp, argmin, √ — which computes the same function. It sums d² in
another order than the kernel, so where the two smallest d² of a row lie
within rounding of each other the two may name different pivots; no
join result changes, because the bounds use only the assigned distance.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from ..device import SMS
from . import build

__all__ = ["assign_plain", "assign_cuda", "plan_assign", "AssignPlan",
           "launches", "last_assign_plan"]

# launches of the CUDA kernel in this process (read and reset through
# ``kernels.ops``)
launches = 0
# the plan of the last launch (what ``chip_smoke.py`` prints)
last_assign_plan = None

_NARROW_D = 32          # widest row of the narrow form
_TILE = 128             # rows a tile-form block, and pivots a tile
_NARROW_WARPS = 8       # warps a narrow-form block
_NARROW_BLOCKS_PER_SM = 2
_MIN_PER = 8            # fewest pivots of an automatic narrow-form split
_NARROW_PIV_BYTES = 48 * 1024   # a narrow-form split's pivots and norms
_NARROW_WIDTHS = (4, 8, 10, 12, 16, 24, 32)   # the kernel's register rows


def _narrow_shape(d: int) -> tuple[int, int]:
    """(rows a lane, most pivots a split) of the narrow form at width d:
    the kernel instance's register width, rounded up to a multiple of 4,
    is the pivots' stride in shared memory."""
    maxd = next(w for w in _NARROW_WIDTHS if d <= w)
    sd = -(-maxd // 4) * 4
    return (4 if d <= 16 else 2), _NARROW_PIV_BYTES // (4 * (sd + 1))


def assign_plain(x: torch.Tensor, pivots: torch.Tensor, *,
                 block: int = 4096) -> tuple[torch.Tensor, torch.Tensor]:
    """(part_id int32 (n,), dist float32 (n,)), in row blocks."""
    p = pivots.to(torch.float32)
    p2 = (p * p).sum(-1, keepdim=True).T                    # (1, M)
    pids, dists = [], []
    for lo in range(0, x.shape[0], block):
        chunk = x[lo:lo + block].to(torch.float32)
        d2 = torch.clamp((chunk * chunk).sum(-1, keepdim=True) + p2
                         - 2.0 * (chunk @ p.T), min=0.0)
        pid = torch.argmin(d2, dim=1)
        pids.append(pid.to(torch.int32))
        dists.append(torch.sqrt(torch.gather(d2, 1, pid[:, None]))[:, 0])
    if not pids:
        return (torch.zeros((0,), dtype=torch.int32, device=x.device),
                torch.zeros((0,), dtype=torch.float32, device=x.device))
    return torch.cat(pids), torch.cat(dists)


class AssignPlan(NamedTuple):
    """How K-A's grid is cut: the ``form`` (``"narrow"``, d <= 32;
    ``"tile"``), ``rows`` a unit of work (a warp's group in the narrow
    form, a block's tile in the tile form), and the pivots in ``splits``
    contiguous ranges of ``per`` (split i covers pivots ``[i·per,
    (i+1)·per)``; the tile form's ranges are whole tiles of 128)."""
    form: str
    rows: int
    splits: int
    per: int


@functools.lru_cache(maxsize=256)
def plan_assign(n: int, m: int, d: int, *, form: Optional[str] = None,
                splits: Optional[int] = None) -> AssignPlan:
    """K-A's cut from static shapes only (no host sync): the narrow form
    where the row fits ``_NARROW_D``, else the tile form (or the forced
    ``form``); enough splits for about ``_NARROW_BLOCKS_PER_SM`` blocks an
    SM (narrow, at least ``_MIN_PER`` pivots a split) or one full wave
    (tile), or the forced ``splits``; never an empty split, and in the
    narrow form never more pivots a split than its shared memory holds."""
    if form is None:
        form = "narrow" if d <= _NARROW_D else "tile"
    if form not in ("narrow", "tile") or (form == "narrow" and d > _NARROW_D):
        raise ValueError(f"K-A has no {form!r} form for d={d}")
    if form == "narrow":
        r, cap = _narrow_shape(d)
        rows, unit = 32 * r, 1
        blocks = -(-n // (rows * _NARROW_WARPS))
    else:
        rows, unit = _TILE, _TILE
        blocks = -(-n // rows)
    units = -(-m // unit)
    if form == "tile":
        cap = units * unit
    if splits is None:
        per_sm = _NARROW_BLOCKS_PER_SM if form == "narrow" else 1
        splits = -(-per_sm * SMS // max(blocks, 1))
        if form == "narrow":
            splits = min(splits, -(-m // _MIN_PER))
    want = max(1, min(int(splits), units, 65535))
    per = min(-(-units // want) * unit, cap)
    return AssignPlan(form, rows, -(-m // per), per)


@functools.cache
def _entry():
    """The kernel's C entry, loaded and typed once per process."""
    fn = build.library("assign").repro_assign
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def assign_cuda(x: torch.Tensor, pivots: torch.Tensor, *,
                form: Optional[str] = None, splits: Optional[int] = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on the current stream of ``x``'s device in the
    form and cut of :func:`plan_assign` (``form`` / ``splits`` force
    them; every choice gives the same bits)."""
    global launches, last_assign_plan
    for name, t in (("x", x), ("pivots", pivots)):
        if not t.is_cuda or t.dtype != torch.float32 or t.dim() != 2 \
                or not t.is_contiguous():
            raise ValueError(f"assign kernel: {name} must be a contiguous "
                             f"2-D float32 CUDA tensor, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if pivots.device != x.device:
        raise ValueError("assign kernel: x and pivots on different devices")
    n, d = x.shape
    m = pivots.shape[0]
    if pivots.shape[1] != d or d < 1 or m < 1 \
            or n * d >= 2 ** 31 or m * d >= 2 ** 31:
        raise ValueError(f"assign kernel takes d >= 1, m >= 1 and fewer "
                         f"than 2^31 elements on each side; got x "
                         f"{tuple(x.shape)}, pivots {tuple(pivots.shape)}")
    pid = torch.empty((n,), dtype=torch.int32, device=x.device)
    dist = torch.empty((n,), dtype=torch.float32, device=x.device)
    if n == 0:
        return pid, dist
    plan = plan_assign(n, m, d, form=form, splits=splits)
    # each split's (d² bits, id) key a row, folded by the launch
    part = (torch.empty((plan.splits, n), dtype=torch.int64, device=x.device)
            if plan.splits > 1 else None)
    with torch.cuda.device(x.device):
        err = _entry()(x.data_ptr(), pivots.data_ptr(), pid.data_ptr(),
                       dist.data_ptr(),
                       None if part is None else part.data_ptr(),
                       n, m, d, int(plan.form == "tile"), plan.splits,
                       plan.per, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"assign kernel launch failed: CUDA error {err} "
                           f"(plan {plan})")
    launches += 1
    last_assign_plan = plan
    return pid, dist
