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

K-D replaces the Pallas ``distance_topk_kernel``
(``kernels/distance_topk.py:71``, wrapper ``distance_topk_pallas``):
the same function over every (R tile, S tile) pair whose
``visit_mask`` entry is non-zero (every pair without a mask), for any
width d. Its plain version walks S in groups of whole tiles for all
queries at once (memory bounded by ``_PLAIN_STEP_ELEMS`` distances) and
folds each group into the run with one stable sort; √ is taken in
float64 and rounded once (the correctly rounded float32 √, as the
kernel's).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import build
from .sorted_merge import next_pow2

__all__ = ["distance_topk_gather_plain", "distance_topk_gather_cuda",
           "distance_topk_plain", "distance_topk_cuda", "launches",
           "dense_launches"]

# widest run either kernel keeps in registers, and widest query K-G
# holds there; past them the kernels keep wide runs in scratch the
# wrappers allocate (two buffers of k entries a query)
_REG_K = 64
_REG_D = 128

# launches of K-G and of K-D in this process (read and reset through
# ``kernels.ops``)
launches = 0
dense_launches = 0

# distances the plain dense version holds at once (128 MB of float32)
_PLAIN_STEP_ELEMS = 1 << 25
# K-D: queries per block, and the blocks its S-axis split aims for
# (~4 per SM of an H100's 132)
_DENSE_BQ = 32
_DENSE_TARGET_BLOCKS = 4 * 132


def distance_topk_gather_plain(
    r: torch.Tensor, s: torch.Tensor, k: int, schedule: torch.Tensor,
    counts: torch.Tensor, *, alive: Optional[torch.Tensor] = None,
    bm: int = 128, bn: int = 512,
) -> tuple[torch.Tensor, torch.Tensor]:
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
    run_p = torch.where(torch.isfinite(run_d), run_p, -1)
    out_d = torch.sqrt(run_d[..., :k]).reshape(nr_tiles * bm, k)[:n_r]
    out_p = run_p[..., :k].reshape(nr_tiles * bm, k)[:n_r]
    return out_d, out_p.to(torch.int32)


@functools.cache
def _entry():
    """The kernel's C entry, loaded and typed once per process."""
    fn = build.library("gather_topk").repro_gather_topk
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 8
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
    bm: int = 128, bn: int = 512,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on the current stream of ``r``'s device. Any d
    and any k: past d = 128 or k = 64 the kernel's general form runs,
    with each query's run in a scratch of 2k entries allocated here."""
    global launches
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
    run_d = run_p = None
    if d > _REG_D or k > _REG_K:
        run_d = torch.empty((n_r, 2 * k), dtype=torch.float32, device=dev)
        run_p = torch.empty((n_r, 2 * k), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = _entry()(
            r.data_ptr(), s.data_ptr(), schedule.data_ptr(),
            counts.data_ptr(), None if alive is None else alive.data_ptr(),
            out_d.data_ptr(), out_p.data_ptr(),
            None if run_d is None else run_d.data_ptr(),
            None if run_p is None else run_p.data_ptr(),
            n_r, n_s, d, k, bm, bn,
            nr_tiles, schedule.shape[1],
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"gather kernel launch failed: CUDA error {err}")
    launches += 1
    return out_d, out_p


def distance_topk_plain(
    r: torch.Tensor, s: torch.Tensor, k: int, *,
    visit_mask: Optional[torch.Tensor] = None, bm: int = 128, bn: int = 512,
) -> tuple[torch.Tensor, torch.Tensor]:
    """k nearest rows of ``s`` per row of ``r`` over the visited (R tile,
    S tile) pairs: ascending (√d² float32, int32 row ids), (+inf, -1)
    for empty slots, ties to the lower id."""
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
    run_p = torch.where(torch.isfinite(run_d), run_p, -1)
    out_d = torch.sqrt(run_d.to(torch.float64)).to(torch.float32)
    return out_d, run_p.to(torch.int32)


@functools.cache
def _dense_entry():
    """K-D's C entry, loaded and typed once per process."""
    fn = build.library("dense_topk").repro_dense_topk
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def distance_topk_cuda(
    r: torch.Tensor, s: torch.Tensor, k: int, *,
    visit_mask: Optional[torch.Tensor] = None, bm: int = 128, bn: int = 512,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch K-D on the current stream of ``r``'s device: a partial
    top-k per (32 queries, split of the S tiles) block, then a merge of
    the splits per query. Any d and any k: past k = 64 the runs are wide
    (k entries in scratch allocated here, two buffers a query)."""
    global dense_launches
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
    wide = k > _REG_K
    kp = 2 * k if wide else max(8, next_pow2(k))
    nr_blocks = nr_tiles * -(-bm // _DENSE_BQ)
    n_splits = min(ns_tiles, 65535,
                   max(1, -(-_DENSE_TARGET_BLOCKS // nr_blocks)))
    part_d = torch.empty((n_splits, n_r, kp), dtype=torch.float32,
                         device=dev)
    part_p = torch.empty((n_splits, n_r, kp), dtype=torch.int32, device=dev)
    scratch_d = scratch_p = None
    if wide:
        scratch_d = torch.empty((n_r, 2 * k), dtype=torch.float32,
                                device=dev)
        scratch_p = torch.empty((n_r, 2 * k), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = _dense_entry()(
            r.data_ptr(), s.data_ptr(),
            None if visit_mask is None else visit_mask.data_ptr(),
            part_d.data_ptr(), part_p.data_ptr(),
            None if scratch_d is None else scratch_d.data_ptr(),
            None if scratch_p is None else scratch_p.data_ptr(),
            out_d.data_ptr(),
            out_p.data_ptr(), n_r, n_s, d, k, bm, bn, n_splits,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"dense kernel launch failed: CUDA error {err}")
    dense_launches += 1
    return out_d, out_p
