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

The kernel takes any d. :func:`plan_attention` chooses, from the shapes
alone, which of its forms runs and how its grid is cut: bf16 with more
than 16 rows per kv head (prefill) on the tensor cores up to d = 256,
everything else (fp32, decode, d > 256) on CUDA cores with the keys
split across blocks (split-KV) and a combine pass.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from ..device import BLOCKS_PER_SM, SMS
from . import build
from .sorted_merge import next_pow2

__all__ = ["flash_attention_plain", "flash_attention_cuda", "launches",
           "last_plan", "NEG_INF", "AttentionPlan", "plan_attention"]

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MMA_WIDTHS = (64, 128, 256)  # head widths the tensor-core form is built for
_SIMT_BK = 128          # keys per tile of the CUDA-core form (split unit)

# launches of the CUDA kernel in this process (read and reset through
# ``kernels.ops``)
launches = 0
# the plan of the last launch (read by the card tests and chip_smoke.py)
last_plan = None


def _scale(d: int, scale: Optional[float]) -> float:
    return 1.0 / (d ** 0.5) if scale is None else float(scale)


class AttentionPlan(NamedTuple):
    """How one K-F call is cut. ``route`` "mma" (tensor cores: ``width`` is
    the padded q·k width DK) or "simt" (CUDA cores: ``width`` is DV, the
    output columns per block; ``bq`` rows per block); ``zc`` chunks of the
    output's d across blocks; ``splits`` key ranges of ``split_keys`` keys
    each (split s covers ``[s·split_keys, (s+1)·split_keys) ∩ [0, nk)``)."""
    route: str
    width: int
    bq: int
    zc: int
    splits: int
    split_keys: int


def plan_attention(bf16: bool, b: int, nq: int, nk: int, h: int, kvh: int,
                   d: int) -> AttentionPlan:
    """K-F's plan from the shapes alone (no tensor is read); split-KV aims
    at ``BLOCKS_PER_SM`` blocks per SM."""
    nv = (h // kvh) * nq            # rows per kv head
    if bf16 and d <= _MMA_WIDTHS[-1] and nv > 16:
        dk = next(w for w in _MMA_WIDTHS if w >= d)
        dv = min(dk, 128)
        return AttentionPlan("mma", dk, 64, -(-d // dv), 1, max(nk, 1))
    bq = 16 if nv <= 16 else 64
    dv = min(128, max(16, next_pow2(d)))
    zc = -(-d // dv)
    n_tiles = max(1, -(-nk // _SIMT_BK))
    blocks = -(-nv // bq) * b * kvh * zc
    want = min(n_tiles, max(1, -(-BLOCKS_PER_SM * SMS // blocks)),
               65535 // zc)
    per = -(-n_tiles // want)       # tiles per split
    return AttentionPlan("simt", dv, bq, zc, -(-n_tiles // per),
                         per * _SIMT_BK)


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
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                   + [ctypes.c_longlong] * 9 + [ctypes.c_int] * 3
                   + [ctypes.c_float] + [ctypes.c_int] * 7
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _vec_ok(d: int, *ts: torch.Tensor) -> bool:
    """16-byte loads: aligned bases, strides and d in whole 16 bytes."""
    per = 16 // ts[0].element_size()
    return d % per == 0 and all(
        t.data_ptr() % 16 == 0 and all(st % per == 0 for st in t.stride()[:3])
        for t in ts)


def flash_attention_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True, window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Launch K-F on the current stream of ``q``'s device, cut as
    :func:`plan_attention` says. k and v are read in place through their
    strides (a live slice of a decode cache needs no copy); the output is
    a new contiguous ``(b, nq, h, d)`` tensor of q's dtype."""
    global launches, last_plan
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
    if (q.dtype not in _DTYPES or d < 1
            or tuple(k.shape) != (b, nk, kvh, d) or v.shape != k.shape
            or kvh < 1 or h % kvh or b * kvh > 65535
            or (h // kvh) * nq >= 2 ** 31 or nk >= 2 ** 31 - _SIMT_BK
            or (window is not None and window < 0)):
        raise ValueError(
            f"flash attention kernel takes float32 or bfloat16, k and v of "
            f"one shape (b, nk, kvh, d), h a multiple of kvh, b·kvh <= "
            f"65535, fewer than 2^31 rows per kv head and keys, and a "
            f"window >= 0; got {q.dtype}, q {tuple(q.shape)}, k "
            f"{tuple(k.shape)}, v {tuple(v.shape)}, window={window}")
    out = torch.empty((b, nq, h, d), dtype=q.dtype, device=q.device)
    if b == 0 or nq == 0:
        return out
    plan = plan_attention(q.dtype == torch.bfloat16, b, nq, nk, h, kvh, d)
    part_m = part_l = part_acc = None
    if plan.splits > 1:
        part_m = torch.empty((plan.splits, b, nq, h), dtype=torch.float32,
                             device=q.device)
        part_l = torch.empty_like(part_m)
        part_acc = torch.empty((plan.splits, b, nq, h, d),
                               dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = _entry()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            *(None if t is None else t.data_ptr()
              for t in (part_m, part_l, part_acc)),
            _DTYPES[q.dtype], b, nq, nk, h, kvh, d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            int(causal), int(window is not None),
            0 if window is None else int(window), _scale(d, scale),
            0 if plan.route == "mma" else 1, plan.width, plan.bq, plan.zc,
            plan.splits, plan.split_keys, int(_vec_ok(d, q, k, v)),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"flash attention kernel launch failed: CUDA error {err} "
            f"(plan {plan})")
    launches += 1
    last_plan = plan
    return out
