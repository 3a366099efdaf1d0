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

Two extensions of the TPU kernel's function, both from the JAX package's
jnp attention (``models/layers.py``): ``softcap`` > 0 caps each scaled
logit to ``tanh(s / cap) · cap`` before the mask (Gemma 2's logit
softcap; ``_sdpa``, the ring and the read-only decode), and ``k_new``,
``v_new`` (``(b, t_new, kvh, d)``) are keys appended after k and v's
``nk`` (the read-only serving cache's decode: the cache's live keys and
the step's fresh ones, one softmax over both). The kernel reads the
second source in place beside the first (no concatenation); a call
with it always takes the CUDA-core form.

The kernel takes any d. :func:`plan_attention` chooses, from the shapes
alone, which of its forms runs and how its grid is cut: bf16 with more
than 16 rows per kv head (prefill) on the tensor cores up to d = 256,
everything else (fp32, decode, d > 256) on CUDA cores with the keys
split across blocks (split-KV) and a combine pass.

Training. K-F also writes, on request, each row's log-sum-exp ``lse =
m + log l`` of the scaled logits (float32, ``(b, h, nq)``; −inf for a row
that sees no key), and the backward kernel ``csrc/flash_attn_bwd.cu``
(K-B) computes ``dq, dk, dv`` from q, k, v, the output, its gradient
and that lse. K-B replaces no TPU kernel: the JAX package differentiates
its jnp attention (``models/layers.py · _sdpa``) and has no Pallas
backward (ROADMAP C9); the port runs its attention on K-F, so K-F needs
a gradient of its own. :class:`FlashAttentionFn` binds the two: its
forward is K-F with lse, its backward K-B (on the CPU the two plain
versions). A direct call of :func:`flash_attention_cuda` with an input
that requires grad raises, since its output carries no gradient.
:func:`plan_attention_bwd` chooses K-B's route from the shapes and the
dtype alone: bf16 on the tensor cores (with deterministic row splits of
the dk/dv pass where the grid is thin), float32 on CUDA cores.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..device import BLOCKS_PER_SM, SMS
from . import build
from .sorted_merge import next_pow2

__all__ = ["flash_attention_plain", "flash_attention_cuda", "launches",
           "last_plan", "NEG_INF", "AttentionPlan", "plan_attention",
           "flash_attention_bwd_plain", "flash_attention_bwd_cuda",
           "bwd_launches", "last_bwd_plan", "AttentionBwdPlan",
           "plan_attention_bwd", "FlashAttentionFn", "BWD_MAX_D"]

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MMA_WIDTHS = (64, 128, 256)  # head widths the tensor-core form is built for
_SIMT_BK = 128          # keys per tile of the CUDA-core form (split unit)

# launches of the CUDA kernels in this process, K-F's and K-B's (read and
# reset through ``kernels.ops``)
launches = 0
bwd_launches = 0
# the plan of the last launch of K-F and of K-B (read by the card tests and
# chip_smoke.py)
last_plan = None
last_bwd_plan = None


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
                   d: int, *, appended: bool = False) -> AttentionPlan:
    """K-F's plan from the shapes alone (no tensor is read); split-KV aims
    at ``BLOCKS_PER_SM`` blocks per SM. ``nk`` counts every key; with
    ``appended`` (a second key source) the CUDA-core form runs."""
    nv = (h // kvh) * nq            # rows per kv head
    if bf16 and d <= _MMA_WIDTHS[-1] and nv > 16 and not appended:
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


def _tile_mask(nq: int, nk: int, i0: int, i1: int, j0: int, j1: int, *,
               causal: bool, window: Optional[int], dev):
    """The (i1 − i0, j1 − j0) visibility mask of one tile pair (queries
    right-aligned to the keys)."""
    q_pos = torch.arange(i0, i1, device=dev)[:, None] + (nk - nq)
    k_pos = torch.arange(j0, j1, device=dev)[None, :]
    mask = q_pos < nk
    if causal:
        mask = mask & (k_pos <= q_pos)
    if window is not None:
        mask = mask & (k_pos > q_pos - window)
    return mask


def flash_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True, window: Optional[int] = None,
    scale: Optional[float] = None, bq: int = 128, bk: int = 128,
    return_lse: bool = False, softcap: float = 0.0,
    k_new: Optional[torch.Tensor] = None,
    v_new: Optional[torch.Tensor] = None,
):
    """The kernel's function in float32, walking the TPU kernel's (bq,
    bk) tiles with its online softmax; a tile no row of the q tile can
    see is skipped, as there (for each row such a tile's update is a
    no-op). With ``return_lse`` also each row's log-sum-exp ``m + log l``
    of the (capped) scaled logits, float32 ``(b, h, nq)``, −inf for a row
    that sees no key. ``k_new`` / ``v_new`` are appended to k / v."""
    if k_new is not None:
        k, v = torch.cat([k, k_new], 1), torch.cat([v, v_new], 1)
    b, nq, h, d = q.shape
    nk, kvh = k.shape[1], k.shape[2]
    if h % kvh:
        raise ValueError(f"q heads {h} are not a multiple of kv heads {kvh}")
    rep = h // kvh
    scale32 = torch.tensor(_scale(d, scale), dtype=torch.float32)
    cap32 = torch.tensor(softcap, dtype=torch.float32)
    dev = q.device
    qf = q.to(torch.float32).permute(0, 2, 1, 3)               # (b, h, nq, d)
    kf = k.to(torch.float32).permute(0, 2, 1, 3).repeat_interleave(rep, 1)
    vf = v.to(torch.float32).permute(0, 2, 1, 3).repeat_interleave(rep, 1)
    out = torch.empty((b, h, nq, d), dtype=torch.float32, device=dev)
    lse = torch.empty((b, h, nq), dtype=torch.float32, device=dev)
    for i0 in range(0, nq, bq):
        i1 = min(nq, i0 + bq)
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
            mask = _tile_mask(nq, nk, i0, i1, j0, j1, causal=causal,
                              window=window, dev=dev)
            s = torch.matmul(qf[:, :, i0:i1],
                             kf[:, :, j0:j1].transpose(-1, -2)) * scale32
            if softcap > 0:
                s = torch.tanh(s / cap32) * cap32
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.matmul(p, vf[:, :, j0:j1])
            m = m_new
        out[:, :, i0:i1] = acc / torch.clamp(l, min=1e-30)[..., None]
        lse[:, :, i0:i1] = torch.where(l > 0, m + torch.log(l),
                                       float("-inf"))
    out = out.permute(0, 2, 1, 3).to(q.dtype)
    return (out, lse) if return_lse else out


def flash_attention_bwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
    do: torch.Tensor, lse: torch.Tensor, *, causal: bool = True,
    window: Optional[int] = None, scale: Optional[float] = None,
    bq: int = 128, bk: int = 128, softcap: float = 0.0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K-B's function in float32 (FlashAttention-2's backward): ``D_i =
    Σ dO_i·o_i``; over the forward's (bq, bk) tiles (a tile no row of
    the q tile can see is skipped) ``p = exp(s − lse)`` with masked p
    forced to 0 (s capped to ``tanh(s / cap) · cap`` when ``softcap`` >
    0), ``dP = dO·vᵀ``, ``dS = p ∘ (dP − D)`` (times ``1 − tanh²(s /
    cap)`` under the cap); ``dv = Σ pᵀ dO``,
    ``dk = Σ dSᵀ q · scale``, ``dq = Σ dS k · scale``, the GQA group's
    heads summed into their kv head. Returns ``(dq, dk, dv)`` in the
    inputs' dtype. A row that sees no key (lse −inf) gets 0."""
    b, nq, h, d = q.shape
    nk, kvh = k.shape[1], k.shape[2]
    rep = h // kvh
    sc = _scale(d, scale)
    cap32 = torch.tensor(softcap, dtype=torch.float32)
    dev = q.device
    f32 = torch.float32
    qf = q.to(f32).permute(0, 2, 1, 3)                   # (b, h, nq, d)
    kf = k.to(f32).permute(0, 2, 1, 3).repeat_interleave(rep, 1)
    vf = v.to(f32).permute(0, 2, 1, 3).repeat_interleave(rep, 1)
    dof = do.to(f32).permute(0, 2, 1, 3)
    dsum = (dof * o.to(f32).permute(0, 2, 1, 3)).sum(-1)   # (b, h, nq)
    lse = lse.to(f32)
    dq = torch.zeros((b, h, nq, d), dtype=f32, device=dev)
    dk = torch.zeros((b, h, nk, d), dtype=f32, device=dev)
    dv = torch.zeros((b, h, nk, d), dtype=f32, device=dev)
    for i0 in range(0, nq, bq):
        i1 = min(nq, i0 + bq)
        first_q, last_q = i0 + nk - nq, i0 + nk - nq + bq - 1
        for j0 in range(0, nk, bk):
            if causal and j0 > last_q:
                continue
            if window is not None and j0 + bk - 1 <= first_q - window:
                continue
            j1 = min(nk, j0 + bk)
            mask = _tile_mask(nq, nk, i0, i1, j0, j1, causal=causal,
                              window=window, dev=dev)
            s = torch.matmul(qf[:, :, i0:i1],
                             kf[:, :, j0:j1].transpose(-1, -2)) * sc
            if softcap > 0:
                t = torch.tanh(s / cap32)
                s = t * cap32
            p = torch.where(mask, torch.exp(s - lse[:, :, i0:i1, None]),
                            0.0)
            dp = torch.matmul(dof[:, :, i0:i1],
                              vf[:, :, j0:j1].transpose(-1, -2))
            ds = p * (dp - dsum[:, :, i0:i1, None])
            if softcap > 0:
                ds = ds * (1 - t * t)
            dq[:, :, i0:i1] += torch.matmul(ds, kf[:, :, j0:j1])
            dk[:, :, j0:j1] += torch.matmul(ds.transpose(-1, -2),
                                            qf[:, :, i0:i1])
            dv[:, :, j0:j1] += torch.matmul(p.transpose(-1, -2),
                                            dof[:, :, i0:i1])
    dk = dk.reshape(b, kvh, rep, nk, d).sum(2)
    dv = dv.reshape(b, kvh, rep, nk, d).sum(2)
    return ((dq * sc).permute(0, 2, 1, 3).to(q.dtype),
            (dk * sc).permute(0, 2, 1, 3).to(k.dtype),
            dv.permute(0, 2, 1, 3).to(v.dtype))


@functools.cache
def _entry():
    """The kernel's C entry, loaded and typed once per process."""
    fn = build.library("flash_attn").repro_flash_attn
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 8
                   + [ctypes.c_longlong] * 15 + [ctypes.c_int] * 3
                   + [ctypes.c_float] * 2 + [ctypes.c_int] * 7
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _vec_ok(d: int, *ts: Optional[torch.Tensor]) -> bool:
    """16-byte loads: aligned bases, strides and d in whole 16 bytes."""
    per = 16 // ts[0].element_size()
    return d % per == 0 and all(
        t.data_ptr() % 16 == 0 and all(st % per == 0 for st in t.stride()[:3])
        for t in ts if t is not None)


def flash_attention_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True, window: Optional[int] = None,
    scale: Optional[float] = None, return_lse: bool = False,
    softcap: float = 0.0, k_new: Optional[torch.Tensor] = None,
    v_new: Optional[torch.Tensor] = None,
):
    """Launch K-F on the current stream of ``q``'s device, cut as
    :func:`plan_attention` says. k and v (and ``k_new``, ``v_new``, read
    after them) are read in place through their strides (a live slice of
    a decode cache needs no copy); the output is
    a new contiguous ``(b, nq, h, d)`` tensor of q's dtype, and with
    ``return_lse`` also each row's log-sum-exp (float32 ``(b, h, nq)``,
    −inf for a row that sees no key; every bit of the output is the same
    either way). Raises for an input that requires grad while grad is
    enabled: the output carries no gradient (``FlashAttentionFn``
    does)."""
    global launches, last_plan
    if not q.is_cuda:
        raise ValueError(f"flash attention kernel: q must be a CUDA tensor, "
                         f"got {q.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise ValueError(
            "flash attention kernel: an input requires grad, and the "
            "kernel's output carries none; call kernels.ops."
            "flash_attention (FlashAttentionFn, whose backward is K-B)")
    if (k_new is None) != (v_new is None):
        raise ValueError("flash attention kernel: k_new and v_new come "
                         "together")
    for name, t in (("q", q), ("k", k), ("v", v), ("k_new", k_new),
                    ("v_new", v_new)):
        if t is None:
            continue
        if t.device != q.device or t.dtype != q.dtype or t.dim() != 4 \
                or t.stride(-1) != 1:
            raise ValueError(
                f"flash attention kernel: {name} must be a 4-D tensor on "
                f"{q.device} of q's dtype {q.dtype} with a contiguous last "
                f"axis, got {t.dtype} {tuple(t.shape)} strides {t.stride()} "
                f"on {t.device}")
    b, nq, h, d = q.shape
    nk1, kvh = k.shape[1], k.shape[2]
    nk = nk1 + (0 if k_new is None else k_new.shape[1])
    if (q.dtype not in _DTYPES or d < 1
            or tuple(k.shape) != (b, nk1, kvh, d) or v.shape != k.shape
            or (k_new is not None and (
                (k_new.shape[0], *k_new.shape[2:]) != (b, kvh, d)
                or v_new.shape != k_new.shape))
            or kvh < 1 or h % kvh or b * kvh > 65535
            or (h // kvh) * nq >= 2 ** 31 or nk >= 2 ** 31 - _SIMT_BK
            or (window is not None and window < 0) or not softcap >= 0):
        raise ValueError(
            f"flash attention kernel takes float32 or bfloat16, k and v of "
            f"one shape (b, nk, kvh, d) (k_new and v_new of one shape (b, "
            f"t, kvh, d)), h a multiple of kvh, b·kvh <= 65535, fewer than "
            f"2^31 rows per kv head and keys, a window >= 0 and a softcap "
            f">= 0; got {q.dtype}, q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)}, k_new "
            f"{None if k_new is None else tuple(k_new.shape)}, "
            f"window={window}, softcap={softcap}")
    out = torch.empty((b, nq, h, d), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, h, nq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if b == 0 or nq == 0:
        return (out, lse) if return_lse else out
    plan = plan_attention(q.dtype == torch.bfloat16, b, nq, nk, h, kvh, d,
                          appended=k_new is not None)
    part_m = part_l = part_acc = None
    if plan.splits > 1:
        part_m = torch.empty((plan.splits, b, nq, h), dtype=torch.float32,
                             device=q.device)
        part_l = torch.empty_like(part_m)
        part_acc = torch.empty((plan.splits, b, nq, h, d),
                               dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = _entry()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            *(None if t is None else t.data_ptr()
              for t in (k_new, v_new)), out.data_ptr(),
            *(None if t is None else t.data_ptr()
              for t in (part_m, part_l, part_acc, lse)),
            _DTYPES[q.dtype], b, nq, nk, nk1, h, kvh, d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *(k_new.stride()[:3] if k_new is not None else (0, 0, 0)),
            *(v_new.stride()[:3] if v_new is not None else (0, 0, 0)),
            int(causal), int(window is not None),
            0 if window is None else int(window), _scale(d, scale),
            float(softcap), 0 if plan.route == "mma" else 1, plan.width,
            plan.bq, plan.zc, plan.splits, plan.split_keys,
            int(_vec_ok(d, q, k, v, k_new, v_new)),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"flash attention kernel launch failed: CUDA error {err} "
            f"(plan {plan})")
    launches += 1
    last_plan = plan
    return (out, lse) if return_lse else out


# head widths K-B is built for (d padded up to the next one)
_BWD_WIDTHS = (32, 64, 128, 192, 256)
BWD_MAX_D = _BWD_WIDTHS[-1]
_BWD_ROUTES = {"mma": 0, "simt": 1}
_BWD_SIMT_TILE = 32     # keys and rows a block of the CUDA-core form owns
_BWD_KEYS = 64          # keys a dk/dv block of the tensor-core form owns
_BWD_STEP = 32          # virtual rows of one of its steps (the split unit)
# dk/dv blocks an SM below which the tensor-core form splits its row steps
# into enough parts to reach that many (the best of 3-17 parts at
# recurrentgemma's MQA shapes on the H100)
_BWD_SPLIT_PER_SM = 3


class AttentionBwdPlan(NamedTuple):
    """How one K-B call is cut. ``route`` "mma" (bf16: tensor cores) or
    "simt" (float32: CUDA cores); ``width`` the head width the kernels
    are instantiated at (d padded with zeros); ``key_tile`` keys a dk/dv
    block owns; ``row_tile`` virtual rows a dq block owns; ``splits``
    interleaved parts of each kv head's row steps (``step_rows`` rows a
    step) in the dk/dv pass — part z takes steps z, z + splits, ... and
    writes float32 partial dk, dv into a scratch of shape ``scratch``
    (``(2, splits, b, nk, kvh, row width)``; ``()`` with one part), which
    a reduce kernel sums in order. The C entry takes the tiles and
    refuses any that its route was not built for at ``width``."""
    route: str
    width: int
    key_tile: int
    row_tile: int
    step_rows: int
    splits: int
    scratch: tuple


def plan_attention_bwd(bf16: bool, b: int, nq: int, nk: int, h: int,
                       kvh: int, d: int) -> AttentionBwdPlan:
    """K-B's plan from the shapes alone (no tensor is read): bf16 on the
    tensor cores, float32 on CUDA cores (the bits of the reduced model's
    card-vs-CPU path and of a restart); in bf16, row splits of the dk/dv
    pass when its blocks ((key tiles) × b × kvh) are fewer than
    ``_BWD_SPLIT_PER_SM`` per SM, enough to reach that many (MQA), never
    more than the row steps."""
    if not 1 <= d <= BWD_MAX_D:
        raise ValueError(f"flash attention backward kernel takes d <= "
                         f"{BWD_MAX_D}, got {d}")
    width = next(w for w in _BWD_WIDTHS if w >= d)
    if not bf16:
        return AttentionBwdPlan("simt", width, _BWD_SIMT_TILE,
                                _BWD_SIMT_TILE, _BWD_SIMT_TILE, 1, ())
    blocks = max(1, -(-nk // _BWD_KEYS) * b * kvh)
    steps = max(1, -(-(h // kvh) * nq // _BWD_STEP))
    splits = 1
    if blocks < _BWD_SPLIT_PER_SM * SMS:
        splits = min(-(-_BWD_SPLIT_PER_SM * SMS // blocks), steps)
    scratch = ((2, splits, b, nk, kvh, -(-d // 8) * 8) if splits > 1
               else ())
    dq_rows = 128 if width > 192 else 64   # rows of a dq block (16 a warp)
    return AttentionBwdPlan("mma", width, _BWD_KEYS, dq_rows, _BWD_STEP,
                            splits, scratch)


def _bwd_buffers(plan: AttentionBwdPlan, q: torch.Tensor):
    """K-B's scratch on q's device: D (float32 ``(b, h, nq)``) and, with
    row splits, the dk/dv partials (float32 ``plan.scratch``)."""
    b, nq, h, _ = q.shape
    dsum = torch.empty((b, h, nq), dtype=torch.float32, device=q.device)
    part = (torch.empty(plan.scratch, dtype=torch.float32, device=q.device)
            if plan.splits > 1 else None)
    return dsum, part


def _aligned16(t: torch.Tensor) -> torch.Tensor:
    """t, or a fresh contiguous copy when its data is not 16-byte
    aligned (the tensor-core form stages rows by 16-byte cp.async)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


@functools.cache
def _bwd_entry():
    """K-B's C entry, loaded and typed once per process."""
    fn = build.library("flash_attn_bwd").repro_flash_attn_bwd
    fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 16
                   + [ctypes.c_float] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def flash_attention_bwd_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
    do: torch.Tensor, lse: torch.Tensor, *, causal: bool = True,
    window: Optional[int] = None, scale: Optional[float] = None,
    softcap: float = 0.0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch K-B (``csrc/flash_attn_bwd.cu``) on the current stream of
    ``q``'s device, cut as :func:`plan_attention_bwd` says: ``(dq, dk,
    dv)`` of K-F's function at the inputs, in their dtype, from K-F's
    output ``o``, its gradient ``do`` and K-F's lse. Deterministic (no
    atomics). Takes float32 or bfloat16 and d up to ``BWD_MAX_D``;
    non-contiguous inputs are copied first, and in bf16 a d that is not
    a multiple of 8 is padded with zeros (the outputs are views cut back
    to d)."""
    global bwd_launches, last_bwd_plan
    if not q.is_cuda:
        raise ValueError(f"flash attention backward kernel: q must be a "
                         f"CUDA tensor, got {q.device}")
    b, nq, h, d = q.shape
    nk, kvh = k.shape[1], k.shape[2]
    for name, t, shape in (("k", k, (b, nk, kvh, d)),
                           ("v", v, (b, nk, kvh, d)),
                           ("o", o, (b, nq, h, d)),
                           ("do", do, (b, nq, h, d))):
        if t.device != q.device or t.dtype != q.dtype \
                or tuple(t.shape) != shape:
            raise ValueError(
                f"flash attention backward kernel: {name} must be "
                f"{shape} {q.dtype} on {q.device}, got {tuple(t.shape)} "
                f"{t.dtype} on {t.device}")
    if (q.dtype not in _DTYPES or not 1 <= d <= BWD_MAX_D or kvh < 1
            or h % kvh or lse.dtype != torch.float32
            or tuple(lse.shape) != (b, h, nq) or lse.device != q.device
            or b * kvh > 65535 or not softcap >= 0
            or (window is not None and window < 0)):
        raise ValueError(
            f"flash attention backward kernel takes float32 or bfloat16, d "
            f"<= {BWD_MAX_D}, h a multiple of kvh, b·kvh <= 65535, a float32 "
            f"lse (b, h, nq), a window >= 0 and a softcap >= 0; got "
            f"{q.dtype}, q {tuple(q.shape)}, k {tuple(k.shape)}, lse "
            f"{lse.dtype} {tuple(lse.shape)}, window={window}, "
            f"softcap={softcap}")
    plan = plan_attention_bwd(q.dtype == torch.bfloat16, b, nq, nk, h, kvh,
                              d)
    q, k, v, o, do, lse = (t.contiguous() for t in (q, k, v, o, do, lse))
    dr = d                                   # the kernel's row width
    if plan.route == "mma":
        dr = -(-d // 8) * 8
        if dr != d:
            q, k, v, o, do = (F.pad(t, (0, dr - d)) for t in (q, k, v, o, do))
        q, k, v, o, do = map(_aligned16, (q, k, v, o, do))
    dq = torch.empty_like(q)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if b == 0 or nq == 0 or nk == 0:
        return dq.zero_()[..., :d], dk.zero_()[..., :d], dv.zero_()[..., :d]
    dsum, part = _bwd_buffers(plan, q)
    with torch.cuda.device(q.device):
        err = _bwd_entry()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), dsum.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(),
            None if part is None else part.data_ptr(), _DTYPES[q.dtype], b,
            nq, nk, h, kvh, dr, _BWD_ROUTES[plan.route], plan.width,
            plan.key_tile, plan.row_tile, plan.step_rows, plan.splits,
            int(causal), int(window is not None),
            0 if window is None else int(window), _scale(d, scale),
            float(softcap), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash attention backward kernel launch failed: "
                           f"CUDA error {err} (plan {plan})")
    bwd_launches += 1
    last_bwd_plan = plan
    if dr != d:
        return dq[..., :d], dk[..., :d], dv[..., :d]
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """K-F's function with a gradient: forward K-F with lse, backward K-B
    (CUDA tensors); the two plain versions on CPU tensors.
    ``FlashAttentionFn.apply(q, k, v, causal, window, scale, softcap)``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale, softcap=0.0):
        fn = flash_attention_cuda if q.is_cuda else flash_attention_plain
        out, lse = fn(q, k, v, causal=causal, window=window, scale=scale,
                      return_lse=True, softcap=softcap)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.attn = dict(causal=causal, window=window, scale=scale,
                        softcap=softcap)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        fn = (flash_attention_bwd_cuda if q.is_cuda
              else flash_attention_bwd_plain)
        dq, dk, dv = fn(q, k, v, out, dout, lse, **ctx.attn)
        return dq, dk, dv, None, None, None, None
