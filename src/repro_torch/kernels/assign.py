"""Nearest-pivot assignment (PGBJ phase-1 hot loop): the CUDA kernel
``csrc/assign.cu`` and its plain PyTorch version.

The kernel replaces the JAX package's Pallas ``assign_kernel``
(``kernels/assign.py:23``); the plain version is the arithmetic of the
JAX package's ``partition._assign_blocked`` — ‖x‖²+‖p‖²−2x·pᵀ with
``torch.matmul``, clamp, argmin, √ — which computes the same function.
The two sum d² in different orders, so where the two smallest d² of a
row lie within rounding of each other they may name different pivots;
no join result changes, because the bounds use only the assigned
distance.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build

__all__ = ["assign_plain", "assign_cuda", "launches"]

# launches of the CUDA kernel in this process (read and reset through
# ``kernels.ops``)
launches = 0


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


@functools.cache
def _entry():
    """The kernel's C entry, loaded and typed once per process."""
    fn = build.library("assign").repro_assign
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def assign_cuda(x: torch.Tensor, pivots: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on the current stream of ``x``'s device."""
    global launches
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
    with torch.cuda.device(x.device):
        err = _entry()(x.data_ptr(), pivots.data_ptr(), pid.data_ptr(),
                       dist.data_ptr(), n, m, d,
                       torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"assign kernel launch failed: CUDA error {err}")
    launches += 1
    return pid, dist
