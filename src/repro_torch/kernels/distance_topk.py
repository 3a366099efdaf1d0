"""Top-k kernels over S tiles: the scheduled gather top-k
(``csrc/gather_topk.cu``, K-G) and the dense top-k
(``csrc/dense_topk.cu``, K-D), each with its plain PyTorch version.

K-G replaces the JAX package's Pallas
``distance_topk_gather_alive_kernel`` / ``distance_topk_gather_kernel``
(``kernels/distance_topk.py:189`` / ``:154``, wrapper
``distance_topk_gather_pallas``) with one kernel and an optional alive
pointer. Both versions return what that wrapper returns: for each row
of ``r``, the k nearest rows of ``s`` among the S tiles its R tile's
schedule names — ascending √d² (float32) and int32 row positions into
``s``, (+inf, -1) for an empty slot. d² = ‖r‖²+‖s‖²−2r·s clamped at 0;
rows at or past ``n_s`` and rows with ``alive <= 0`` never enter; slots
at or past ``counts[i]`` are dead; ties go to the lower position.

The plain version walks the same schedule slot by slot (never a dense
scan, which computes another function whenever the schedule prunes)
and folds each slot's tile into the carried run with one stable sort.
Its candidates of a slot all lie past the run's positions because
schedule rows are ascending (``core.schedule.compact_visits``), so the
stable sort is what sends ties to the lower position.

K-G cuts each R tile's schedule row into contiguous visit ranges
(:func:`plan_gather`, from static shapes only) and merges the ranges'
partial runs in (d², position) order; the selection is exact, so every
cut gives the plain version's bits.

K-D replaces the Pallas ``distance_topk_kernel``
(``kernels/distance_topk.py:71``, wrapper ``distance_topk_pallas``):
the same function over every (R tile, S tile) pair whose
``visit_mask`` entry is non-zero (every pair without a mask), for any
width d. Its plain version walks S in groups of whole tiles for all
queries at once (memory bounded by ``_PLAIN_STEP_ELEMS`` distances) and
folds each group into the run with one stable sort; √ is taken in
float64 and rounded once (the correctly rounded float32 √, as the
kernel's). K-D has two forms, chosen by :func:`plan_dense` from the
static shapes (a narrow register-query scan, a fused fp32 tile for wide
rows and wide runs); both cut S into contiguous ranges of S tiles whose
partial runs merge in (d², id) order, so every cut selects the same
rows.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from ..device import BLOCKS_PER_SM, SMS
from . import build
from .sorted_merge import next_pow2

__all__ = ["distance_topk_gather_plain", "distance_topk_gather_cuda",
           "distance_topk_plain", "distance_topk_cuda", "launches",
           "dense_launches", "last_plan", "last_dense_plan", "GatherPlan",
           "plan_gather", "DensePlan", "plan_dense"]

# widest run either kernel keeps in registers, and widest query K-G
# holds there; past them the kernels keep wide runs in scratch the
# wrappers allocate (two buffers of k entries a query)
_REG_K = 64
_REG_D = 128

# launches of K-G and of K-D in this process (read and reset through
# ``kernels.ops``)
launches = 0
dense_launches = 0
# the plans of the last K-G and K-D launches (read by the card tests and
# chip_smoke.py)
last_plan = None
last_dense_plan = None

# distances the plain dense version holds at once (128 MB of float32)
_PLAIN_STEP_ELEMS = 1 << 25
# K-D: queries per block (both forms), and the widest row of its narrow
# form (the query held in registers)
_DENSE_QB = 128
_NARROW_D = 32
# blocks an SM K-D's narrow form aims at (64- or 128-thread blocks); its
# tile form (a block fills an SM's shared memory) aims at one full wave
# where a batch has few R tiles, else at BLOCKS_PER_SM
_NARROW_BLOCKS_PER_SM = 8


def _gather_runs_plain(r, s, k, schedule, counts, alive, bm, bn):
    """The scheduled kp-runs (d², int64 positions), kp = next_pow2(k),
    shaped (nr_tiles, bm, kp); empty slots (+inf, -1)."""
    n_r, d = r.shape
    n_s = s.shape[0]
    dev = r.device
    nr_tiles = -(-n_r // bm)
    ns_tiles = -(-n_s // bn)
    kp = next_pow2(k)
    r3 = torch.nn.functional.pad(r.to(torch.float32),
                                 (0, 0, 0, nr_tiles * bm - n_r))
    r3 = r3.reshape(nr_tiles, bm, d)
    rn = (r3 * r3).sum(-1)                                    # (nr, bm)
    s_pad = torch.nn.functional.pad(s.to(torch.float32),
                                    (0, 0, 0, ns_tiles * bn - n_s))
    sn = (s_pad * s_pad).sum(-1)
    live = torch.arange(ns_tiles * bn, device=dev) < n_s
    if alive is not None:
        live &= torch.nn.functional.pad(alive.to(torch.float32),
                                        (0, ns_tiles * bn - n_s)) > 0.0
    cols = torch.arange(bn, device=dev)
    run_d = torch.full((nr_tiles, bm, kp), float("inf"), device=dev)
    run_p = torch.full((nr_tiles, bm, kp), -1, dtype=torch.int64, device=dev)
    for j in range(schedule.shape[1]):
        tile = schedule[:, j].to(torch.int64)
        ok_tile = (j < counts) & (tile >= 0) & (tile < ns_tiles)
        pos = torch.clamp(tile, 0, ns_tiles - 1)[:, None] * bn + cols
        st = s_pad[pos]                                       # (nr, bn, d)
        d2 = torch.clamp(rn[..., None] + sn[pos][:, None, :]
                         - 2.0 * torch.bmm(r3, st.transpose(1, 2)),
                         min=0.0)                             # (nr, bm, bn)
        ok = ok_tile[:, None] & live[pos]
        d2 = torch.where(ok[:, None, :], d2, float("inf"))
        cand_d = torch.cat([run_d, d2], dim=-1)
        cand_p = torch.cat([run_p, pos[:, None, :].expand(-1, bm, -1)],
                           dim=-1)
        cand_d, order = torch.sort(cand_d, dim=-1, stable=True)
        run_d = cand_d[..., :kp]
        run_p = torch.take_along_dim(cand_p, order[..., :kp], dim=-1)
    return run_d, torch.where(torch.isfinite(run_d), run_p, -1)


def _runs_out(run_d, run_p, n_r, k):
    """A (nr_tiles, bm, kp) run as the kernel's output: √ of the first k
    d² (float32) and int32 positions, rows past n_r dropped."""
    nr_tiles, bm = run_d.shape[:2]
    out_d = torch.sqrt(run_d[..., :k]).reshape(nr_tiles * bm, k)[:n_r]
    out_p = run_p[..., :k].reshape(nr_tiles * bm, k)[:n_r]
    return out_d, out_p.to(torch.int32)


def distance_topk_gather_plain(
    r: torch.Tensor, s: torch.Tensor, k: int, schedule: torch.Tensor,
    counts: torch.Tensor, *, alive: Optional[torch.Tensor] = None,
    bm: int = 128, bn: int = 512,
) -> tuple[torch.Tensor, torch.Tensor]:
    run_d, run_p = _gather_runs_plain(r, s, k, schedule, counts, alive, bm,
                                      bn)
    return _runs_out(run_d, run_p, r.shape[0], k)


class GatherPlan(NamedTuple):
    """How K-G's grid is cut: blocks of ``warps`` warps, each warp serving
    ``qw`` queries, and each R tile's schedule row in ``splits``
    contiguous visit ranges of ``per`` slots (split i covers slots
    ``[i·per, (i+1)·per)``)."""
    warps: int
    qw: int
    splits: int
    per: int


def plan_gather(n_r: int, d: int, k: int, bm: int, max_visits: int, *,
                splits: Optional[int] = None) -> GatherPlan:
    """K-G's cut from static shapes only (never ``counts``): about
    ``BLOCKS_PER_SM`` blocks with a live query per SM, or the forced
    ``splits``. Where the register runs and the query fit twice in
    registers (k <= 16, d <= 32) a warp serves 2 queries, and a block has
    16 warps where the batch fills them (held to 128 registers a thread);
    every other form has 8 warps of one query each."""
    pair = d <= 32 and k <= 16
    qw = 2 if pair else 1
    warps = 16 if pair and min(n_r, bm) >= 16 * qw else 8
    qb = warps * qw
    nr_tiles = -(-n_r // bm)
    last = n_r - (nr_tiles - 1) * bm
    live = (nr_tiles - 1) * -(-bm // qb) + -(-min(last, bm) // qb)
    if splits is None:
        splits = -(-BLOCKS_PER_SM * SMS // live)
    want = max(1, min(int(splits), max_visits, 65535))
    per = -(-max_visits // want)
    return GatherPlan(warps, qw, -(-max_visits // per), per)


@functools.cache
def _entry():
    """The kernel's C entry, loaded and typed once per process."""
    fn = build.library("gather_topk").repro_gather_topk
    fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 12
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(name, t, dtype, dim, device):
    if t.device != device or t.dtype != dtype or t.dim() != dim \
            or not t.is_contiguous():
        raise ValueError(
            f"kernel argument {name} must be a contiguous {dim}-D {dtype} "
            f"tensor on {device}, got {t.dtype} {tuple(t.shape)} on "
            f"{t.device}")


def distance_topk_gather_cuda(
    r: torch.Tensor, s: torch.Tensor, k: int, schedule: torch.Tensor,
    counts: torch.Tensor, *, alive: Optional[torch.Tensor] = None,
    bm: int = 128, bn: int = 512, splits: Optional[int] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on the current stream of ``r``'s device: each R
    tile's schedule row cut into :func:`plan_gather`'s visit ranges
    (``splits`` forces their number; every count gives the same bits),
    then a merge of the ranges' partial runs. Any d and any k: past d =
    128 or k = 64 the kernel's general form runs, with each query's run
    in scratch of 2k entries a split allocated here."""
    global launches, last_plan
    if not r.is_cuda:
        raise ValueError(f"gather kernel: r must be a CUDA tensor, got "
                         f"{r.device}")
    dev = r.device
    _check("r", r, torch.float32, 2, dev)
    _check("s", s, torch.float32, 2, dev)
    _check("schedule", schedule, torch.int32, 2, dev)
    _check("counts", counts, torch.int32, 1, dev)
    if alive is not None:
        _check("alive", alive, torch.float32, 1, dev)
    n_r, d = r.shape
    n_s = s.shape[0]
    nr_tiles = -(-n_r // bm) if bm >= 1 else 0
    if (s.shape[1] != d or d < 1 or k < 1 or bm < 1 or bn < 1 or n_s < 1
            or schedule.shape[0] != nr_tiles or schedule.shape[1] < 1
            or nr_tiles > 65535
            or counts.shape[0] != nr_tiles
            or (alive is not None and alive.shape[0] != n_s)
            or n_r * d >= 2 ** 31 or n_s * d >= 2 ** 31):
        raise ValueError(
            f"gather kernel takes d, k >= 1, fewer than 2^31 elements on "
            f"each side, a (ceil(n_r/bm), V >= 1) schedule and matching "
            f"counts/alive; "
            f"got r {tuple(r.shape)}, s {tuple(s.shape)}, k={k}, bm={bm}, "
            f"bn={bn}, schedule {tuple(schedule.shape)}, counts "
            f"{tuple(counts.shape)}"
            + ("" if alive is None else f", alive {tuple(alive.shape)}"))
    out_d = torch.empty((n_r, k), dtype=torch.float32, device=dev)
    out_p = torch.empty((n_r, k), dtype=torch.int32, device=dev)
    if n_r == 0:
        return out_d, out_p
    max_visits = schedule.shape[1]
    plan = plan_gather(n_r, d, k, bm, max_visits, splits=splits)
    wide = d > _REG_D or k > _REG_K
    width = 2 * k if wide else max(8, next_pow2(k))
    part_d = part_p = scratch_d = scratch_p = None
    if wide or plan.splits > 1:
        part_d = torch.empty((plan.splits, n_r, width), dtype=torch.float32,
                             device=dev)
        part_p = torch.empty((plan.splits, n_r, width), dtype=torch.int32,
                             device=dev)
    if wide and plan.splits > 1:
        scratch_d = torch.empty((n_r, 2 * k), dtype=torch.float32,
                                device=dev)
        scratch_p = torch.empty((n_r, 2 * k), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = _entry()(
            r.data_ptr(), s.data_ptr(), schedule.data_ptr(),
            counts.data_ptr(), None if alive is None else alive.data_ptr(),
            out_d.data_ptr(), out_p.data_ptr(),
            *(None if t is None else t.data_ptr()
              for t in (part_d, part_p, scratch_d, scratch_p)),
            n_r, n_s, d, k, bm, bn, nr_tiles, max_visits, *plan,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"gather kernel launch failed: CUDA error {err} "
                           f"(plan {plan})")
    launches += 1
    last_plan = plan
    return out_d, out_p


def _dense_runs_plain(r, s, k, visit_mask, bm, bn):
    """The dense runs: (n_r, k) ascending d² and int64 row ids over the
    visited (R tile, S tile) pairs, (+inf, -1) for empty slots, ties to
    the lower id."""
    n_r = r.shape[0]
    n_s = s.shape[0]
    dev = r.device
    r = r.to(torch.float32)
    s = s.to(torch.float32)
    ns_tiles = -(-n_s // bn)
    rn = (r * r).sum(1)
    run_d = torch.full((n_r, k), float("inf"), device=dev)
    run_p = torch.full((n_r, k), -1, dtype=torch.int64, device=dev)
    row_mask = None
    if visit_mask is not None:
        tile_of_row = torch.arange(n_r, device=dev) // bm
        row_mask = visit_mask.to(dev)[tile_of_row] != 0     # (n_r, ns_tiles)
    step = max(1, _PLAIN_STEP_ELEMS // (max(n_r, 1) * bn))
    for t0 in range(0, ns_tiles, step):
        lo, hi = t0 * bn, min(n_s, (t0 + step) * bn)
        sc = s[lo:hi]
        d2 = torch.clamp(rn[:, None] + (sc * sc).sum(1)[None, :]
                         - 2.0 * (r @ sc.T), min=0.0)
        cols = torch.arange(lo, hi, device=dev)
        if row_mask is not None:
            d2 = torch.where(row_mask[:, cols // bn], d2, float("inf"))
        cand_d = torch.cat([run_d, d2], dim=1)
        cand_p = torch.cat([run_p, cols[None, :].expand(n_r, -1)], dim=1)
        cand_d, order = torch.sort(cand_d, dim=1, stable=True)
        run_d = cand_d[:, :k]
        run_p = torch.take_along_dim(cand_p, order[:, :k], dim=1)
    return run_d, torch.where(torch.isfinite(run_d), run_p, -1)


def distance_topk_plain(
    r: torch.Tensor, s: torch.Tensor, k: int, *,
    visit_mask: Optional[torch.Tensor] = None, bm: int = 128, bn: int = 512,
) -> tuple[torch.Tensor, torch.Tensor]:
    """k nearest rows of ``s`` per row of ``r`` over the visited (R tile,
    S tile) pairs: ascending (√d² float32, int32 row ids), (+inf, -1)
    for empty slots, ties to the lower id."""
    run_d, run_p = _dense_runs_plain(r, s, k, visit_mask, bm, bn)
    out_d = torch.sqrt(run_d.to(torch.float64)).to(torch.float32)
    return out_d, run_p.to(torch.int32)


class DensePlan(NamedTuple):
    """How K-D's grid is cut: the ``form`` (``"narrow"``: a query or two a
    thread in registers, d <= ``_NARROW_D`` and k <= 64; ``"tile"``: the
    fused fp32 128 × 128 tile with wide runs), ``qblocks`` blocks of 128
    queries per R tile, and the S tiles in ``splits`` contiguous ranges of
    ``per`` tiles (split i covers S tiles ``[i·per, (i+1)·per)``)."""
    form: str
    qblocks: int
    splits: int
    per: int


def plan_dense(n_r: int, n_s: int, d: int, k: int, bm: int, bn: int, *,
               form: Optional[str] = None,
               splits: Optional[int] = None) -> DensePlan:
    """K-D's cut from static shapes only (no host sync): the narrow form
    where the row fits ``_NARROW_D`` and the run fits registers, else the
    tile form (or the forced ``form``); about ``_NARROW_BLOCKS_PER_SM``
    blocks an SM (narrow), one full wave (tile, for a batch of few R
    tiles) or ``BLOCKS_PER_SM`` (tile), or the forced ``splits``; never
    an empty split."""
    if form is None:
        form = "narrow" if d <= _NARROW_D and k <= _REG_K else "tile"
    if form not in ("narrow", "tile") or (
            form == "narrow" and (d > _NARROW_D or k > _REG_K)):
        raise ValueError(f"K-D has no {form!r} form for d={d}, k={k}")
    nr_tiles = -(-n_r // bm)
    ns_tiles = -(-n_s // bn)
    qblocks = -(-bm // _DENSE_QB)
    last = n_r - (nr_tiles - 1) * bm
    live = (nr_tiles - 1) * qblocks + -(-min(last, bm) // _DENSE_QB)
    if splits is None:
        if form == "narrow":
            per_sm = _NARROW_BLOCKS_PER_SM
        else:     # one full wave for a batch of few R tiles, else four
            per_sm = 1 if 8 * live <= SMS else BLOCKS_PER_SM
        splits = -(-per_sm * SMS // live)
    want = max(1, min(int(splits), ns_tiles, 65535))
    per = -(-ns_tiles // want)
    return DensePlan(form, qblocks, -(-ns_tiles // per), per)


@functools.cache
def _dense_entry():
    """K-D's C entry, loaded and typed once per process."""
    fn = build.library("dense_topk").repro_dense_topk
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 9
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def distance_topk_cuda(
    r: torch.Tensor, s: torch.Tensor, k: int, *,
    visit_mask: Optional[torch.Tensor] = None, bm: int = 128, bn: int = 512,
    form: Optional[str] = None, splits: Optional[int] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch K-D on the current stream of ``r``'s device in the form and
    cut of :func:`plan_dense` (``form`` / ``splits`` force them; every
    choice selects the same rows), then a merge of the splits per query.
    Any d and any k: past k = 64 the tile form keeps each query's run of k
    entries in scratch allocated here (two buffers a query and split)."""
    global dense_launches, last_dense_plan
    if not r.is_cuda:
        raise ValueError(f"dense kernel: r must be a CUDA tensor, got "
                         f"{r.device}")
    dev = r.device
    _check("r", r, torch.float32, 2, dev)
    _check("s", s, torch.float32, 2, dev)
    n_r, d = r.shape
    n_s = s.shape[0]
    nr_tiles = -(-n_r // bm) if bm >= 1 else 0
    ns_tiles = -(-n_s // bn) if bn >= 1 else 0
    if visit_mask is not None:
        _check("visit_mask", visit_mask, torch.int8, 2, dev)
    if (s.shape[1] != d or d < 1 or k < 1 or bm < 1
            or bn < 1 or n_s < 1 or n_s >= 2 ** 31 or n_r >= 2 ** 31
            or (visit_mask is not None
                and tuple(visit_mask.shape) != (nr_tiles, ns_tiles))):
        raise ValueError(
            f"dense kernel takes d, k >= 1, 1 <= n_s < 2^31 "
            f"and a (ceil(n_r/bm), ceil(n_s/bn)) int8 visit mask; got r "
            f"{tuple(r.shape)}, s {tuple(s.shape)}, k={k}, bm={bm}, bn={bn}"
            + ("" if visit_mask is None
               else f", visit_mask {tuple(visit_mask.shape)}"))
    out_d = torch.empty((n_r, k), dtype=torch.float32, device=dev)
    out_p = torch.empty((n_r, k), dtype=torch.int32, device=dev)
    if n_r == 0:
        return out_d, out_p
    plan = plan_dense(n_r, n_s, d, k, bm, bn, form=form, splits=splits)
    tile = plan.form == "tile"
    wide = k > _REG_K            # the tile form's runs in device memory
    width = 2 * k if wide else max(8, next_pow2(k))
    part_d = part_p = scratch_d = scratch_p = None
    if wide or plan.splits > 1:
        part_d = torch.empty((plan.splits, n_r, width), dtype=torch.float32,
                             device=dev)
        part_p = torch.empty((plan.splits, n_r, width), dtype=torch.int32,
                             device=dev)
    if wide and plan.splits > 1:
        scratch_d = torch.empty((n_r, 2 * k), dtype=torch.float32,
                                device=dev)
        scratch_p = torch.empty((n_r, 2 * k), dtype=torch.int32, device=dev)
    # the splits' shared bound on each query's final k-th d²
    bound = torch.full((n_r,), float("inf"), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _dense_entry()(
            r.data_ptr(), s.data_ptr(),
            None if visit_mask is None else visit_mask.data_ptr(),
            *(None if t is None else t.data_ptr()
              for t in (part_d, part_p, scratch_d, scratch_p)),
            out_d.data_ptr(), out_p.data_ptr(), bound.data_ptr(), n_r, n_s, d,
            k, bm, bn,
            int(tile), plan.splits, plan.per,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"dense kernel launch failed: CUDA error {err} "
                           f"(plan {plan})")
    dense_launches += 1
    last_dense_plan = plan
    return out_d, out_p
