"""Scheduled gather top-k: the CUDA kernel ``csrc/gather_topk.cu`` and
its plain PyTorch version.

The kernel replaces the JAX package's Pallas
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
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import build
from .sorted_merge import next_pow2

__all__ = ["distance_topk_gather_plain", "distance_topk_gather_cuda",
           "launches", "MAX_K", "MAX_DIM"]

MAX_K = 64       # widest run the kernel keeps in registers
MAX_DIM = 128

# launches of the CUDA kernel in this process (read and reset through
# ``kernels.ops``)
launches = 0


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
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(name, t, dtype, dim, device):
    if t.device != device or t.dtype != dtype or t.dim() != dim \
            or not t.is_contiguous():
        raise ValueError(
            f"gather kernel: {name} must be a contiguous {dim}-D {dtype} "
            f"tensor on {device}, got {t.dtype} {tuple(t.shape)} on "
            f"{t.device}")


def distance_topk_gather_cuda(
    r: torch.Tensor, s: torch.Tensor, k: int, schedule: torch.Tensor,
    counts: torch.Tensor, *, alive: Optional[torch.Tensor] = None,
    bm: int = 128, bn: int = 512,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on the current stream of ``r``'s device."""
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
    if (s.shape[1] != d or not 1 <= d <= MAX_DIM or not 1 <= k <= MAX_K
            or bm < 1 or bn < 1 or n_s < 1
            or schedule.shape[0] != nr_tiles or schedule.shape[1] < 1
            or nr_tiles > 65535
            or counts.shape[0] != nr_tiles
            or (alive is not None and alive.shape[0] != n_s)
            or n_r * d >= 2 ** 31 or n_s * d >= 2 ** 31):
        raise ValueError(
            f"gather kernel takes 1 <= d <= {MAX_DIM}, 1 <= k <= {MAX_K}, "
            f"a (ceil(n_r/bm), V >= 1) schedule and matching counts/alive; "
            f"got r {tuple(r.shape)}, s {tuple(s.shape)}, k={k}, bm={bm}, "
            f"bn={bn}, schedule {tuple(schedule.shape)}, counts "
            f"{tuple(counts.shape)}"
            + ("" if alive is None else f", alive {tuple(alive.shape)}"))
    out_d = torch.empty((n_r, k), dtype=torch.float32, device=dev)
    out_p = torch.empty((n_r, k), dtype=torch.int32, device=dev)
    if n_r == 0:
        return out_d, out_p
    with torch.cuda.device(dev):
        err = _entry()(
            r.data_ptr(), s.data_ptr(), schedule.data_ptr(),
            counts.data_ptr(), None if alive is None else alive.data_ptr(),
            out_d.data_ptr(), out_p.data_ptr(), n_r, n_s, d, k, bm, bn,
            nr_tiles, schedule.shape[1],
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"gather kernel launch failed: CUDA error {err}")
    launches += 1
    return out_d, out_p
