"""Int8 coarse scan of the quantized tier: the CUDA kernel
``csrc/quant_coarse.cu`` (K-Q) and its plain PyTorch versions.

The kernel replaces the JAX package's Pallas
``quant_coarse_gather_kernel`` (``kernels/quant_topk.py:105``, wrapper
``quant_coarse_gather_pallas``). For each query, over the S tiles its R
tile's schedule names, it keeps the ``mp`` smallest *certified lower
bounds* ``lb = max(d_coarse − (ε_s + ε_q + ε_num + 1e-7), 0)`` of the
rows that are alive and have ``lb ≤ θ``: ascending (lb float32, int32
row position), ties to the lower position, (+inf, -1) for an empty
slot. ``d_coarse`` comes from the int8 codes — an exact integer dot, one
float32 rescale per (query, S tile) — and ε_num = δ / max(d_coarse, √δ),
δ = ``NUM_DELTA_REL``·(‖q̂‖² + ‖ŝ‖²), dominates the float32 rounding of
the rescale and √ (:func:`coarse_lb_tile`).

The plain versions compute the same chain with one torch op per float32
operation (no fused multiply-add), the integer dot in float64 (exact)
and each √ in float64 rounded once (the correctly rounded float32 √,
as the kernel's), so kernel and plain version give bit-equal lb:
:func:`quant_coarse_sched_plain` walks the schedule slot by slot,
:func:`quant_coarse_topk_plain` scans every row (the dense oracle).

The kernel cuts each R tile's schedule row into contiguous ranges
(:func:`plan_quant`, from static shapes only) and merges the ranges'
partial runs in (lb, position) order, so every cut gives the unsplit
bits. Before the √ chain it drops the pairs whose coarse d2 exceeds a
limit T that implies lb > min(θ, the run's tail); :func:`screen_limit_plain`
computes T as the kernel does, for the CPU tests of its soundness.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..device import SMS
from . import build

__all__ = ["NUM_DELTA_REL", "NUM_TOL_ABS", "coarse_lb_tile",
           "quant_coarse_topk_plain", "quant_coarse_sched_plain",
           "quant_coarse_gather_cuda", "launches", "last_plan", "QuantPlan",
           "plan_quant", "quant_smem_bytes", "screen_limit_plain"]

# float32 rounding allowance of the rescale + √: |d2_f32 − d2_exact| ≤
# δ = NUM_DELTA_REL·(‖q̂‖² + ‖ŝ‖²) — the int8 dot and the squared norms
# are exact, so only ~5 fp32 ops round, each against a term of at most
# 2(‖q̂‖²+‖ŝ‖²); 2e-6 ≈ 16 ulp is a 3× margin. In distance space the
# error is at most δ / max(d, √δ).
NUM_DELTA_REL = 2e-6
NUM_TOL_ABS = 1e-7
_DELTA_F32 = float(np.float32(NUM_DELTA_REL))
_TOL_F32 = float(np.float32(NUM_TOL_ABS))

# launches of the CUDA kernel in this process (read and reset through
# ``kernels.ops``), and the plan of the last launch (read by the card tests
# and chip_smoke.py)
launches = 0
last_plan = None


def _sqrt32(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 √ on every backend."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def _lb_chain(c, a, b, qscale, qeps, sscale, seps):
    """The certified lower bound from the exact integer parts: ``c``
    (..., bm, bn) dots, ``a`` (..., bm) and ``b`` (..., bn) squared
    norms (all float32, exact integers), per-query ``qscale``/``qeps``
    (..., bm) and per-row ``sscale``/``seps`` (..., bn). One op per
    rounding, in ``coarse_lb_tile``'s order."""
    q2 = (qscale * qscale) * a
    s2 = (sscale * sscale) * b
    qs2 = q2[..., :, None] + s2[..., None, :]
    d2 = qs2 - (2.0 * (qscale[..., :, None] * sscale[..., None, :])) * c
    dc = _sqrt32(torch.clamp(d2, min=0.0))
    delta = _DELTA_F32 * qs2
    eps_num = delta / torch.maximum(dc, _sqrt32(delta))
    eps_t = ((seps[..., None, :] + qeps[..., :, None]) + eps_num) + _TOL_F32
    return torch.clamp(dc - eps_t, min=0.0)


def _int_parts(qi: torch.Tensor, si: torch.Tensor):
    """(c, a, b) of int8 codes as exact float32 integers: the dot in
    float64 (exact for dim·127² < 2⁵³) and the squared norms in int32."""
    c = torch.matmul(qi.to(torch.float64),
                     si.to(torch.float64).transpose(-1, -2))
    a = qi.to(torch.int32).square().sum(-1)
    b = si.to(torch.int32).square().sum(-1)
    return c.to(torch.float32), a.to(torch.float32), b.to(torch.float32)


def coarse_lb_tile(qi, qscale, qeps, si, sscale, seps) -> torch.Tensor:
    """Certified per-pair lower bounds for one (query, S) code block —
    the JAX package's ``kernels.quant_topk.coarse_lb_tile``.

    ``qi`` (bm, dim) int8, ``qscale``/``qeps`` (bm,) float32; ``si``
    (bn, dim) int8, ``sscale`` a scalar (one tile) or a (bn,) per-row
    vector (several tiles at once), ``seps`` (bn,). Returns (bm, bn)
    float32 ``max(d_coarse − ε_total, 0)``."""
    c, a, b = _int_parts(qi, si)
    sscale = torch.as_tensor(sscale, dtype=torch.float32,
                             device=qi.device).expand(si.shape[0])
    return _lb_chain(c, a, b, qscale.to(torch.float32),
                     qeps.to(torch.float32), sscale,
                     seps.to(torch.float32))


def quant_coarse_topk_plain(qi, qscale, qeps, theta, si, sscale, seps,
                            alive, mp: int, *, bn: int):
    """Dense oracle (the JAX package's ``kernels.ref.
    quant_coarse_topk_ref``): the certified bounds over *all* S rows —
    a candidate superset of any schedule — then the ``mp`` smallest
    kept (lb, position) pairs. ``sscale`` per tile ((n_s // bn,))."""
    n_s = si.shape[0]
    lb = coarse_lb_tile(qi, qscale, qeps, si,
                        torch.repeat_interleave(sscale.to(torch.float32), bn),
                        seps)
    keep = (alive.to(torch.float32) > 0.0)[None, :] & (lb <= theta[:, None])
    lb = torch.where(keep, lb, float("inf"))
    lb, pos = torch.sort(lb, dim=1, stable=True)    # ties → lower position
    lb, pos = lb[:, :mp], pos[:, :mp]
    if n_s < mp:
        lb = torch.nn.functional.pad(lb, (0, mp - n_s), value=float("inf"))
        pos = torch.nn.functional.pad(pos, (0, mp - n_s), value=-1)
    pos = torch.where(torch.isfinite(lb), pos, -1)
    return lb, pos.to(torch.int32)


def _lexsort_run(d: torch.Tensor, p: torch.Tensor):
    """Order (..., n) pairs by (d, p): a stable sort by position, then a
    stable sort by d."""
    order = torch.argsort(p, dim=-1, stable=True)
    d, p = torch.take_along_dim(d, order, -1), torch.take_along_dim(
        p, order, -1)
    d, order = torch.sort(d, dim=-1, stable=True)
    return d, torch.take_along_dim(p, order, -1)


def quant_coarse_sched_plain(qi, qscale, qeps, theta, si, sscale, seps,
                             alive, mp: int, schedule, counts, *,
                             bm: int = 128, bn: int = 512):
    """The kernel's function as torch ops: walk the schedule slot by
    slot, score each scheduled tile with the certified bound chain, fold
    the kept pairs into the carried (lb, position) run. Slots at or past
    ``counts[i]`` and out-of-range tiles are dead. ``si`` must be
    tile-padded (a multiple of ``bn`` rows)."""
    n_r, d = qi.shape
    n_s = si.shape[0]
    dev = qi.device
    if n_s % bn:
        raise ValueError(f"quantized S must be tile-padded: {n_s} % {bn}")
    nr_tiles = -(-n_r // bm)
    ns_tiles = n_s // bn
    pad = nr_tiles * bm - n_r
    inf = float("inf")

    def rows(x, fill):
        return torch.nn.functional.pad(x.to(torch.float32), (0, pad),
                                       value=fill).reshape(nr_tiles, bm)
    # padding queries: θ = -inf keeps nothing
    qsc3, qe3, th3 = rows(qscale, 1.0), rows(qeps, 0.0), rows(theta, -inf)
    q3 = torch.nn.functional.pad(qi, (0, 0, 0, pad)).reshape(nr_tiles, bm, d)
    a3 = q3.to(torch.int32).square().sum(-1).to(torch.float32)
    q3 = q3.to(torch.float64)
    b_all = si.to(torch.int32).square().sum(-1).to(torch.float32)
    ssc = sscale.to(torch.float32)
    seps32 = seps.to(torch.float32)
    live = alive.to(torch.float32) > 0.0
    cols = torch.arange(bn, device=dev)
    run_lb = torch.full((nr_tiles, bm, mp), inf, device=dev)
    run_p = torch.full((nr_tiles, bm, mp), -1, dtype=torch.int64, device=dev)
    for j in range(schedule.shape[1]):
        tile = schedule[:, j].to(torch.int64)
        ok_tile = (j < counts) & (tile >= 0) & (tile < ns_tiles)
        tc = torch.clamp(tile, 0, ns_tiles - 1)
        pos = tc[:, None] * bn + cols                          # (nr, bn)
        c = torch.bmm(q3, si[pos].to(torch.float64).transpose(1, 2))
        lb = _lb_chain(c.to(torch.float32), a3, b_all[pos], qsc3, qe3,
                       ssc[tc][:, None].expand(-1, bn), seps32[pos])
        keep = ((ok_tile[:, None] & live[pos])[:, None, :]
                & (lb <= th3[..., None]))
        lb = torch.where(keep, lb, inf)
        run_lb, run_p = _lexsort_run(
            torch.cat([run_lb, lb], dim=-1),
            torch.cat([run_p, pos[:, None, :].expand(-1, bm, -1)], dim=-1))
        run_lb, run_p = run_lb[..., :mp], run_p[..., :mp]
    run_p = torch.where(torch.isfinite(run_lb), run_p, -1)
    return (run_lb.reshape(nr_tiles * bm, mp)[:n_r],
            run_p.reshape(nr_tiles * bm, mp)[:n_r].to(torch.int32))


class QuantPlan(NamedTuple):
    """How K-Q's grid is cut: blocks of ``qb`` queries of one R tile (16
    warps of ``qpw`` <= 4 queries), the S tile rows staged ``chunk`` at a time,
    runs in shared memory or, ``wide`` (mp > 512), in device memory, and
    each R tile's schedule row in ``splits`` contiguous ranges of ``per``
    slots (split i covers slots ``[i·per, (i+1)·per)``)."""
    qb: int
    qpw: int
    wide: bool
    chunk: int
    splits: int
    per: int


_WARPS = 16
_RUN_BYTES = 64 * 1024        # shared-memory runs of a block
_CODE_BYTES = 16 * 1024       # int8 codes of one staged chunk
_SMEM_BYTES = 227 * 1024      # shared memory a block may use (H100)
_CAP = 64                     # candidates of a query waiting to merge
_QUEUE = 160                  # pairs of a warp waiting for the exact chain
# blocks an SM the split count aims at (one fits at a time: a block that
# finishes early leaves room for the next, so several waves balance)
_BLOCKS_PER_SM = 16


def _a16(x: int) -> int:
    return (x + 15) // 16 * 16


def quant_smem_bytes(qb: int, mp: int, d: int, chunk: int, wide: bool) -> int:
    """The kernel's shared memory for one block (``Layout`` in
    ``csrc/quant_coarse.cu``)."""
    words = 8 if d > 32 else 4     # the tensor-core dot takes 32 codes a step
    nw4 = (-(-d // 4) + words - 1) // words * words
    sw = nw4 if nw4 % 8 == 4 else nw4 + 4     # padded packed row
    run_n = 0 if wide else mp
    return (2 * _a16(qb * run_n * 4) + 2 * _a16(qb * _CAP * 4)
            + _a16(qb * 4) + _a16(_WARPS * _QUEUE * 20)
            + _a16(qb * nw4 * 4) + _a16(qb * 32)
            + _a16(qb * 8) + _a16(2 * (_a16(chunk * d) + 16))
            + _a16(2 * _a16(chunk * 2)) + _a16(2 * chunk * 4)
            + _a16(chunk * sw * 4) + 2 * _a16(chunk * 4) + 32)


def plan_quant(n_r: int, d: int, mp: int, bm: int, bn: int,
               max_visits: int, *, splits: Optional[int] = None) -> QuantPlan:
    """K-Q's cut from static shapes only (never ``counts``): a block holds
    64 queries of an R tile (16 warps of up to 4), 32 or 16 where their
    runs would pass ``_RUN_BYTES`` of shared memory (fewer for a small R
    tile; 32 with wide runs); rows staged in chunks of about
    ``_CODE_BYTES`` of codes (a
    multiple of 16 rows); about ``_BLOCKS_PER_SM`` blocks an SM (one with
    wide runs) or the forced ``splits``, never an empty split."""
    wide = mp > 512
    qb = 32 if wide else 64
    while not wide and qb > 16 and qb * mp * 8 > _RUN_BYTES:
        qb //= 2
    while qb > 16 and qb // 2 >= bm:
        qb //= 2
    chunk = bn if bn % 16 else min(bn, max(16, _CODE_BYTES // d // 16 * 16))
    while chunk > 16 and quant_smem_bytes(qb, mp, d, chunk, wide) > _SMEM_BYTES:
        chunk = max(16, chunk // 32 * 16)
    nr_tiles = -(-n_r // bm)
    qblocks = -(-bm // qb)
    last = n_r - (nr_tiles - 1) * bm
    live = (nr_tiles - 1) * qblocks + -(-min(last, bm) // qb)
    if splits is None:
        per_sm = 1 if wide else _BLOCKS_PER_SM
        splits = -(-per_sm * SMS // live)
    want = max(1, min(int(splits), max_visits, 65535))
    per = -(-max_visits // want)
    return QuantPlan(qb, qb // _WARPS, wide, chunk, -(-max_visits // per),
                     per)


def _ru32(x: torch.Tensor) -> torch.Tensor:
    """float64 values (each exactly representable, or the correctly
    rounded float64 of a real) rounded up to float32: the float32 at or
    above. Exact where ``x`` holds the real value exactly."""
    f = x.to(torch.float32)
    return torch.where(f.to(torch.float64) < x,
                       torch.nextafter(f, torch.full_like(f, float("inf"))),
                       f)


def _add_ru(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """RU(a + b) of float32 tensors: the float64 sum and its rounding
    error (two-sum) say on which side of it the real sum lies."""
    a64, b64 = a.to(torch.float64), b.to(torch.float64)
    s = a64 + b64
    bb = s - a64
    err = (a64 - (s - bb)) + (b64 - bb)
    f = s.to(torch.float32)
    f64 = f.to(torch.float64)
    up = (f64 < s) | ((f64 == s) & (err > 0))
    return torch.where(up & torch.isfinite(s),
                       torch.nextafter(f, torch.full_like(f, float("inf"))), f)


def _mul_ru(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """RU(a · b) of float32 tensors (the product is exact in float64)."""
    return _ru32(a.to(torch.float64) * b.to(torch.float64))


def _sqrt_ru(a: torch.Tensor) -> torch.Tensor:
    """RU(√a) of a float32 tensor a >= 0: the float32 whose square (exact
    in float64) first reaches a."""
    a64 = a.to(torch.float64)
    f = torch.sqrt(a64).to(torch.float32)
    inf = torch.full_like(f, float("inf"))
    f = torch.where(f.to(torch.float64) ** 2 < a64, torch.nextafter(f, inf), f)
    lo = torch.nextafter(f, -inf)
    return torch.where((f > 0) & (lo.to(torch.float64) ** 2 >= a64), lo, f)


def screen_limit_plain(cut, qe, q2, seps_max, s2_max) -> torch.Tensor:
    """The kernel's screen limit T (float32, elementwise): a pair whose
    coarse d2 exceeds T has lb > ``cut`` (the soundness argument is in
    ``csrc/quant_coarse.cu``). Round-up done in float64 and rounded
    toward +inf, as CUDA's ``__fadd_ru`` / ``__fmul_ru`` /
    ``__fsqrt_ru``."""
    f32 = [torch.as_tensor(x, dtype=torch.float32)
           for x in (cut, qe, q2, seps_max, s2_max)]
    cut, qe, q2, seps_max, s2_max = torch.broadcast_tensors(*f32)
    delta = _mul_ru(torch.full_like(q2, _DELTA_F32), _add_ru(q2, s2_max))
    eps_num = _mul_ru(_sqrt_ru(delta),
                      torch.full_like(q2, 1.0 + 2.0 ** -22))
    eps_t = _add_ru(_add_ru(_add_ru(seps_max, qe), eps_num),
                    torch.full_like(q2, _TOL_F32))
    dd = _add_ru(torch.nextafter(cut, torch.full_like(cut, float("inf"))),
                 eps_t)
    return torch.where(dd > 0, _mul_ru(dd, dd),
                       torch.full_like(dd, float("-inf")))


@functools.cache
def _entry():
    """The kernel's C entry, loaded and typed once per process."""
    fn = build.library("quant_coarse").repro_quant_coarse
    fn.argtypes = ([ctypes.c_void_p] * 18 + [ctypes.c_int] * 14
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(name, t, dtype, shape, device):
    if (t.device != device or t.dtype != dtype or tuple(t.shape) != shape
            or not t.is_contiguous()):
        raise ValueError(
            f"quant coarse kernel: {name} must be a contiguous {dtype} "
            f"tensor of shape {shape} on {device}, got {t.dtype} "
            f"{tuple(t.shape)} on {t.device}")


def quant_coarse_gather_cuda(qi, qscale, qeps, theta, si, sscale, seps,
                             alive, mp: int, schedule, counts, *,
                             bm: int = 128, bn: int = 512,
                             splits: Optional[int] = None,
                             stats: Optional[torch.Tensor] = None):
    """Launch the kernel on the current stream of ``qi``'s device in the
    cut of :func:`plan_quant` (``splits`` forces the split count; every
    count gives the same bits): ``qi`` (n_r, d) int8,
    ``qscale``/``qeps``/``theta`` (n_r,) float32, ``si`` (ns_tiles·bn, d)
    int8, ``sscale`` (ns_tiles,) float32, ``seps`` (ns_tiles·bn,)
    float16, ``alive`` (ns_tiles·bn,) float32, ``schedule``
    (ceil(n_r/bm), V) int32, ``counts`` int32. Any d and any power-of-two
    mp. ``stats``, a (2,) int64 tensor or None (the main path), gets the
    live pairs screened and the pairs that reached the exact chain
    added."""
    global launches, last_plan
    if not qi.is_cuda:
        raise ValueError(f"quant coarse kernel: qi must be a CUDA tensor, "
                         f"got {qi.device}")
    dev = qi.device
    n_r, d = qi.shape
    n_s = si.shape[0]
    nr_tiles = -(-n_r // bm) if bm >= 1 else 0
    if (d < 1 or mp < 1 or mp & (mp - 1) or bm < 1 or bn < 1
            or n_s < bn or n_s % bn or not 1 <= nr_tiles <= 65535
            or schedule.dim() != 2
            or schedule.shape[1] < 1 or n_r * d >= 2 ** 31
            or n_s * d >= 2 ** 31):
        raise ValueError(
            f"quant coarse kernel takes d >= 1, mp a power of two, S "
            f"tile-padded to a multiple of bn, 1..65535 R tiles and fewer "
            f"than 2^31 codes on each side; got qi {tuple(qi.shape)}, si "
            f"{tuple(si.shape)}, mp={mp}, bm={bm}, bn={bn}, schedule "
            f"{tuple(schedule.shape)}")
    ns_tiles = n_s // bn
    for name, t, dtype, shape in (
            ("qi", qi, torch.int8, (n_r, d)),
            ("qscale", qscale, torch.float32, (n_r,)),
            ("qeps", qeps, torch.float32, (n_r,)),
            ("theta", theta, torch.float32, (n_r,)),
            ("si", si, torch.int8, (n_s, d)),
            ("sscale", sscale, torch.float32, (ns_tiles,)),
            ("seps", seps, torch.float16, (n_s,)),
            ("alive", alive, torch.float32, (n_s,)),
            ("schedule", schedule, torch.int32,
             (nr_tiles, schedule.shape[1])),
            ("counts", counts, torch.int32, (nr_tiles,))):
        _check(name, t, dtype, shape, dev)
    if stats is not None:
        _check("stats", stats, torch.int64, (2,), dev)
    max_visits = schedule.shape[1]
    plan = plan_quant(n_r, d, mp, bm, bn, max_visits, splits=splits)
    bulk = (bn % 16 == 0 and plan.chunk % 16 == 0
            and all(t.data_ptr() % 16 == 0 for t in (si, seps, alive)))
    out_lb = torch.empty((n_r, mp), dtype=torch.float32, device=dev)
    out_pos = torch.empty((n_r, mp), dtype=torch.int32, device=dev)
    part_lb = part_pos = scratch_lb = scratch_pos = None
    if plan.wide or plan.splits > 1:
        width = 2 * mp if plan.wide else mp
        part_lb = torch.empty((plan.splits, n_r, width), dtype=torch.float32,
                              device=dev)
        part_pos = torch.empty((plan.splits, n_r, width), dtype=torch.int32,
                               device=dev)
    if plan.splits > 1:
        scratch_lb = torch.empty((n_r, 2 * mp), dtype=torch.float32,
                                 device=dev)
        scratch_pos = torch.empty((n_r, 2 * mp), dtype=torch.int32,
                                  device=dev)
    # the splits' shared bound on each query's final mp-th lb
    bound = torch.full((n_r,), float("inf"), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _entry()(
            qi.data_ptr(), qscale.data_ptr(), qeps.data_ptr(),
            theta.data_ptr(), si.data_ptr(), sscale.data_ptr(),
            seps.data_ptr(), alive.data_ptr(), schedule.data_ptr(),
            counts.data_ptr(), out_lb.data_ptr(), out_pos.data_ptr(),
            *(None if t is None else t.data_ptr()
              for t in (part_lb, part_pos, scratch_lb, scratch_pos, bound,
                        stats)),
            n_r, n_s, d, mp, bm, bn, nr_tiles, max_visits, plan.qpw,
            int(plan.wide), plan.chunk, plan.splits, plan.per, int(bulk),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"quant coarse kernel launch failed: CUDA error {err} (plan "
            f"{plan})")
    launches += 1
    last_plan = plan
    return out_lb, out_pos
