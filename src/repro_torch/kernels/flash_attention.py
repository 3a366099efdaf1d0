"""Flash attention (forward): the CUDA kernel ``csrc/flash_attn.cu``
(K-F) and its plain PyTorch version.

The kernel replaces the JAX package's Pallas ``_fa_kernel``
(``kernels/flash_attention.py:27``, wrapper ``flash_attention_pallas``).
Both versions compute that wrapper's function: q ``(b, nq, h, d)``, k
and v ``(b, nk, kvh, d)``; query head ``hq`` reads kv head ``hq //
(h // kvh)`` (GQA); query row ``i`` sits at position ``i + nk − nq``
(right-aligned, so prefill and a decode step over a cache are the same
call); key ``j`` is visible when ``j < nk``, ``j ≤`` the position
(``causal``) and ``j >`` the position − ``window``. Over keys in tiles
of ``bk`` with inputs upcast to float32: logits ``(q·k)·scale`` masked
to −1e30, the online softmax (running max, sum and accumulator, each
tile rescaled by ``exp(m − m')``), p forced to 0 where masked, p·v in
float32, and ``acc / max(l, 1e−30)`` cast to q's dtype — a row that
sees no key comes out 0, not NaN. ``scale`` defaults to ``d ** −0.5``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import build

__all__ = ["flash_attention_plain", "flash_attention_cuda", "launches",
           "HEAD_DIMS", "NEG_INF"]

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128, 256)   # head widths the kernel is built for
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# launches of the CUDA kernel in this process (read and reset through
# ``kernels.ops``)
launches = 0


def _scale(d: int, scale: Optional[float]) -> float:
    return 1.0 / (d ** 0.5) if scale is None else float(scale)


def flash_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True, window: Optional[int] = None,
    scale: Optional[float] = None, bq: int = 128, bk: int = 128,
) -> torch.Tensor:
    """The kernel's function in float32, walking the TPU kernel's (bq,
    bk) tiles with its online softmax; a tile no row of the q tile can
    see is skipped, as there (for each row such a tile's update is a
    no-op)."""
    b, nq, h, d = q.shape
    nk, kvh = k.shape[1], k.shape[2]
    if h % kvh:
        raise ValueError(f"q heads {h} are not a multiple of kv heads {kvh}")
    rep = h // kvh
    scale32 = torch.tensor(_scale(d, scale), dtype=torch.float32)
    dev = q.device
    qf = q.to(torch.float32).permute(0, 2, 1, 3)               # (b, h, nq, d)
    kf = k.to(torch.float32).permute(0, 2, 1, 3).repeat_interleave(rep, 1)
    vf = v.to(torch.float32).permute(0, 2, 1, 3).repeat_interleave(rep, 1)
    out = torch.empty((b, h, nq, d), dtype=torch.float32, device=dev)
    for i0 in range(0, nq, bq):
        i1 = min(nq, i0 + bq)
        q_pos = torch.arange(i0, i1, device=dev)[:, None] + (nk - nq)
        first_q, last_q = i0 + nk - nq, i0 + nk - nq + bq - 1
        m = torch.full((b, h, i1 - i0), NEG_INF, device=dev)
        l = torch.zeros((b, h, i1 - i0), device=dev)
        acc = torch.zeros((b, h, i1 - i0, d), device=dev)
        for j0 in range(0, nk, bk):
            if causal and j0 > last_q:
                continue
            if window is not None and j0 + bk - 1 <= first_q - window:
                continue
            j1 = min(nk, j0 + bk)
            k_pos = torch.arange(j0, j1, device=dev)[None, :]
            mask = q_pos < nk
            if causal:
                mask = mask & (k_pos <= q_pos)
            if window is not None:
                mask = mask & (k_pos > q_pos - window)
            s = torch.matmul(qf[:, :, i0:i1],
                             kf[:, :, j0:j1].transpose(-1, -2))
            s = torch.where(mask, s * scale32, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.matmul(p, vf[:, :, j0:j1])
            m = m_new
        out[:, :, i0:i1] = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 2, 1, 3).to(q.dtype)


@functools.cache
def _entry():
    """The kernel's C entry, loaded and typed once per process."""
    fn = build.library("flash_attn").repro_flash_attn
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                   + [ctypes.c_longlong] * 9 + [ctypes.c_int] * 3
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def flash_attention_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True, window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Launch K-F on the current stream of ``q``'s device. k and v are
    read in place through their strides (a live slice of a decode cache
    needs no copy); the output is a new contiguous ``(b, nq, h, d)``
    tensor of q's dtype. The kernel's key tile is 128, the TPU kernel's
    default ``bk``."""
    global launches
    if not q.is_cuda:
        raise ValueError(f"flash attention kernel: q must be a CUDA tensor, "
                         f"got {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype or t.dim() != 4 \
                or t.stride(-1) != 1:
            raise ValueError(
                f"flash attention kernel: {name} must be a 4-D tensor on "
                f"{q.device} of q's dtype {q.dtype} with a contiguous last "
                f"axis, got {t.dtype} {tuple(t.shape)} strides {t.stride()} "
                f"on {t.device}")
    b, nq, h, d = q.shape
    nk, kvh = k.shape[1], k.shape[2]
    if (q.dtype not in _DTYPES or d not in HEAD_DIMS
            or tuple(k.shape) != (b, nk, kvh, d) or v.shape != k.shape
            or kvh < 1 or h % kvh or b * kvh > 65535
            or (window is not None and window < 0)):
        raise ValueError(
            f"flash attention kernel takes float32 or bfloat16, d in "
            f"{HEAD_DIMS}, k and v of one shape (b, nk, kvh, d), h a "
            f"multiple of kvh, b·kvh <= 65535 and a window >= 0; got "
            f"{q.dtype}, q {tuple(q.shape)}, k {tuple(k.shape)}, v "
            f"{tuple(v.shape)}, window={window}")
    out = torch.empty((b, nq, h, d), dtype=q.dtype, device=q.device)
    if b == 0 or nq == 0:
        return out
    with torch.cuda.device(q.device):
        err = _entry()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPES[q.dtype], b, nq, nk, h, kvh, d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            int(causal), int(window is not None),
            0 if window is None else int(window), _scale(d, scale),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"flash attention kernel launch failed: CUDA error {err}")
    launches += 1
    return out
