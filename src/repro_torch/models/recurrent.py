"""Recurrent blocks, PyTorch port of the JAX package's
``models.recurrent``: xLSTM's mLSTM (chunkwise) and sLSTM (a scan over
time), Griffin's RG-LRU, and their causal depthwise conv.

Each kind has ``*_init`` (parameters drawn from an explicit
``torch.Generator``, in the JAX layout, as ``models.layers``), ``*_apply``
over a full sequence (train, prefill, or a prefill that continues from a
carried state) or one decode step, and ``*_init_state``. None of them
reaches a TPU kernel in the JAX package, so the scans are plain torch:

- RG-LRU's linear recurrence h_t = a_t·h_{t-1} + b_t is a log-depth
  Hillis–Steele scan over T (the JAX package's ``associative_scan``
  combines the same pairs in another order);
- mLSTM runs in chunks of 64: parallel products inside a chunk, a loop
  over chunks carrying (C, n, m) in float32, a tail padded with
  log i = −1e30 (no write) and log f = 0 (state kept);
- sLSTM mixes h_{t-1} into its gates, so it loops over time.

As in the JAX package, ``lam``, ``fgate_bias`` and ``f_bias`` stay
float32 inside a bfloat16 model (:data:`FLOAT32_LEAVES`); RG-LRU's h and
sLSTM's four states come back in the model dtype, mLSTM's C, n and m in
float32.

RG-LRU's gates — r, i, log a = −8·softplus(Λ)·r, a = e^{log a} and b =
√(1 − a²)·i·u — are taken in float64 and a and b rounded once to
float32, as the RoPE tables are (``layers.rope_tables``): 1 − a²
cancels (a² ≈ 0.9–0.999), so the one-ulp differences of the card's and
the CPU's float32 exp grow to ~3e-5 of b; over 300 steps of the scan
they moved the reduced recurrentgemma's logits on an H100 3.1× past the
2e-5 + 2e-5·|logit| that holds card and CPU together (0.48 of it with
the gates in float64).
Against the JAX package's float32 chain the logits stay within the same
limit. The scan itself stays float32.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from .layers import apply_norm, dense, dense_init, norm_init, normal_init

__all__ = ["FLOAT32_LEAVES", "conv1d_init", "conv1d_apply",
           "rglru_block_init", "rglru_block_apply", "rglru_init_state",
           "mlstm_block_init", "mlstm_block_apply", "mlstm_init_state",
           "slstm_block_init", "slstm_block_apply", "slstm_init_state"]

Params = Dict[str, Any]

# parameter leaves kept float32 whatever the model dtype
FLOAT32_LEAVES = ("lam", "fgate_bias", "f_bias")
_F32 = torch.float32


# ------------------------------------------------------- causal conv 1d
def conv1d_init(gen: torch.Generator, width: int, channels: int, dtype,
                device) -> Params:
    return {"w": normal_init(gen, (width, channels), width ** -0.5, dtype,
                             device)}


def conv1d_apply(p: Params, x: torch.Tensor,
                 state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv. x (B, T, C); state (B, W−1, C) for decode.
    Returns (y, new_state)."""
    w = p["w"]                                   # (W, C)
    width = w.shape[0]
    pad = (torch.zeros((x.shape[0], width - 1, x.shape[2]), dtype=x.dtype,
                       device=x.device) if state is None else state)
    xp = torch.cat([pad, x], dim=1)              # (B, T+W−1, C)
    t = x.shape[1]
    y = xp[:, 0:t] * w[0]
    for i in range(1, width):
        y = y + xp[:, i:i + t] * w[i]
    return y, xp[:, -(width - 1):]


# --------------------------------------------------------------- RG-LRU
_RGLRU_C = 8.0


def rglru_block_init(gen: torch.Generator, cfg: ArchConfig, dtype,
                     device) -> Params:
    d = cfg.d_model
    dr = int(d * cfg.expand)
    # Λ so that a ≈ 0.9..0.999 (Griffin's init range)
    u = torch.rand((dr,), generator=gen, dtype=_F32, device=device) \
        * (0.999 - 0.9) + 0.9
    p = {"in": dense_init(gen, d, dr, dtype, device),
         "gate": dense_init(gen, d, dr, dtype, device),
         "conv": conv1d_init(gen, cfg.conv_width, dr, dtype, device)}
    # elementwise (diagonal) RG-LRU gates
    for name in ("w_a", "b_a", "w_x", "b_x"):
        p[name] = torch.zeros((dr,), dtype=dtype, device=device)
    p["lam"] = torch.log(torch.expm1(-torch.log(u) / _RGLRU_C))
    p["out"] = dense_init(gen, dr, d, dtype, device)
    return p


def _linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t·h_{t−1} + b_t from h_{−1} = 0 along axis 1, as a
    Hillis–Steele scan: log2(T) rounds, each combining every step with
    the one ``off`` before it by (a_l, b_l)∘(a_r, b_r) = (a_l·a_r,
    a_r·b_l + b_r)."""
    off = 1
    t = a.shape[1]
    while off < t:
        a_r, b_r = a[:, off:], b[:, off:]
        b = torch.cat([b[:, :off], a_r * b[:, :-off] + b_r], dim=1)
        a = torch.cat([a[:, :off], a[:, :-off] * a_r], dim=1)
        off *= 2
    return b


def rglru_block_apply(p: Params, x: torch.Tensor, cfg: ArchConfig,
                      state: Optional[Params] = None
                      ) -> Tuple[torch.Tensor, Params]:
    """x (B, T, D) → (B, T, D); state {"h": (B, Dr), "conv": (B, W−1,
    Dr)}."""
    u = dense(p["in"], x)                                       # (B, T, Dr)
    g = F.gelu(dense(p["gate"], x), approximate="tanh")
    u, conv_state = conv1d_apply(
        p["conv"], u, None if state is None else state["conv"])

    # the gates in float64, a and b rounded once to float32 (module
    # docstring)
    u64 = u.to(torch.float64)
    r = torch.sigmoid(u64 * p["w_a"].to(torch.float64)
                      + p["b_a"].to(torch.float64))
    i = torch.sigmoid(u64 * p["w_x"].to(torch.float64)
                      + p["b_x"].to(torch.float64))
    log_a = -_RGLRU_C * F.softplus(p["lam"].to(torch.float64)) * r
    a = torch.exp(log_a).to(_F32)                               # (B, T, Dr)
    b = (torch.sqrt(torch.clamp(-torch.expm1(2.0 * log_a), min=1e-12))
         * (i * u64)).to(_F32)
    del u64, r, i, log_a

    if x.shape[1] > 1:
        # fold a carried state into the first step, so a prefill can
        # continue from a checkpointed state
        if state is not None:
            b = torch.cat([b[:, :1] + a[:, :1] * state["h"].to(_F32)[:, None],
                           b[:, 1:]], dim=1)
        h = _linear_scan(a, b)
    else:
        h_prev = (torch.zeros_like(b[:, 0]) if state is None
                  else state["h"].to(_F32))[:, None]
        h = a * h_prev + b          # T == 1 for decode
    new_state = {"h": h[:, -1].to(x.dtype), "conv": conv_state}
    y = dense(p["out"], h.to(x.dtype) * g)
    return y, new_state


def rglru_init_state(cfg: ArchConfig, batch: int, dtype, device) -> Params:
    dr = int(cfg.d_model * cfg.expand)
    return {"h": torch.zeros((batch, dr), dtype=dtype, device=device),
            "conv": torch.zeros((batch, cfg.conv_width - 1, dr), dtype=dtype,
                                device=device)}


# ---------------------------------------------------------------- mLSTM
def mlstm_block_init(gen: torch.Generator, cfg: ArchConfig, dtype,
                     device) -> Params:
    d = cfg.d_model
    di = int(d * cfg.expand)                    # inner width (pf = 2)
    h = cfg.n_heads
    return {
        "up": dense_init(gen, d, di, dtype, device),
        "up_gate": dense_init(gen, d, di, dtype, device),
        "conv": conv1d_init(gen, cfg.conv_width, di, dtype, device),
        "q": dense_init(gen, di, di, dtype, device),
        "k": dense_init(gen, di, di, dtype, device),
        "v": dense_init(gen, di, di, dtype, device),
        "igate": dense_init(gen, di, h, dtype, device, scale=0.01),
        "fgate": dense_init(gen, di, h, dtype, device, scale=0.01),
        "fgate_bias": torch.full((h,), 3.0, dtype=_F32, device=device),
        "gn": norm_init(di, "rms", dtype, device),   # one RMS norm over di
        "down": dense_init(gen, di, d, dtype, device),
    }


def _mlstm_chunk_scan(q, k, v, log_i, log_f, chunk: int, init=None):
    """Exact chunkwise mLSTM. q, k, v (B, H, T, dh) float32; gates (B, H,
    T) in log space; T a multiple of ``chunk``. Returns (h (B, H, T, dh),
    the final (C, n, m))."""
    b, h, t, dh = q.shape
    nc = t // chunk
    scale = dh ** -0.5
    qc = q.reshape(b, h, nc, chunk, dh)
    kc = k.reshape(b, h, nc, chunk, dh)
    vc = v.reshape(b, h, nc, chunk, dh)
    li = log_i.reshape(b, h, nc, chunk)
    # cumulative log-forget within each chunk (inclusive)
    lf_cum = torch.cumsum(log_f.reshape(b, h, nc, chunk), dim=-1)
    lf_tot = lf_cum[..., -1]                                    # (B, H, nc)
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=q.device))
    if init is None:
        C = torch.zeros((b, h, dh, dh), dtype=_F32, device=q.device)
        n = torch.zeros((b, h, dh), dtype=_F32, device=q.device)
        m = torch.full((b, h), -1e30, dtype=_F32, device=q.device)
    else:
        C, n, m = init
    outs = []
    for c in range(nc):
        qt, kt, vt = qc[:, :, c], kc[:, :, c], vc[:, :, c]
        lit, lfct, lftot = li[:, :, c], lf_cum[:, :, c], lf_tot[:, :, c]
        # the incoming state decays to position i by f_1..f_i; key j
        # survives to position i ≥ j with log w_ij = lf_cum[i] − lf_cum[j]
        # + li[j]
        log_w = lfct[..., :, None] - lfct[..., None, :] + lit[..., None, :]
        log_w = torch.where(causal, log_w, -math.inf)
        # stabilizer per position: max(m_prev + decay, max_j log w_ij)
        m_intra = torch.amax(log_w, dim=-1)                     # (B, H, c)
        m_new = torch.maximum(m[..., None] + lfct, m_intra)
        w = torch.exp(log_w - m_new[..., None])                 # (B, H, c, c)
        scores = torch.einsum("bhid,bhjd->bhij", qt, kt) * scale
        sw_intra = scores * w
        num_intra = torch.einsum("bhij,bhjd->bhid", sw_intra, vt)
        den_intra = sw_intra.sum(-1)
        sw = torch.exp(m[..., None] + lfct - m_new)             # (B, H, c)
        num_inter = torch.einsum("bhid,bhde->bhie", qt, C) * sw[..., None] \
            * scale
        den_inter = torch.einsum("bhid,bhd->bhi", qt, n) * sw * scale
        den = torch.maximum(torch.abs(den_intra + den_inter),
                            torch.exp(-m_new))                  # max(|n|, 1)
        outs.append((num_intra + num_inter) / den[..., None])
        # the state at the chunk's end
        tail = lit + lftot[..., None] - lfct
        m_next = torch.maximum(m + lftot, torch.amax(tail, dim=-1))
        kw = torch.exp(tail - m_next[..., None])                # (B, H, c)
        decay = torch.exp(m + lftot - m_next)
        C = C * decay[..., None, None] + torch.einsum(
            "bhjd,bhje->bhde", kt * kw[..., None], vt)
        n = n * decay[..., None] + torch.einsum("bhjd,bhj->bhd", kt, kw)
        m = m_next
    return torch.stack(outs, dim=2).reshape(b, h, t, dh), (C, n, m)


def mlstm_block_apply(p: Params, x: torch.Tensor, cfg: ArchConfig,
                      state: Optional[Params] = None, chunk: int = 64
                      ) -> Tuple[torch.Tensor, Params]:
    """x (B, T, D) → (B, T, D); state {"C", "n", "m" (float32), "conv"}."""
    b, t, d = x.shape
    di = int(d * cfg.expand)
    h = cfg.n_heads
    dh = di // h
    x1 = dense(p["up"], x)
    x2 = dense(p["up_gate"], x)
    xc, conv_state = conv1d_apply(
        p["conv"], x1, None if state is None else state["conv"])
    xc = F.silu(xc)

    def heads(y):                                   # (B, T, di) → (B, H, T, dh)
        return y.reshape(b, t, h, dh).permute(0, 2, 1, 3).to(_F32)

    q, k, v = heads(dense(p["q"], xc)), heads(dense(p["k"], xc)), \
        heads(dense(p["v"], x1))
    log_i = dense(p["igate"], xc).to(_F32).permute(0, 2, 1)
    log_f = F.logsigmoid(dense(p["fgate"], xc).to(_F32)
                         + p["fgate_bias"]).permute(0, 2, 1)    # (B, H, T)

    if t > 1:
        pad = (-t) % chunk
        if pad:
            q, k, v = (F.pad(a, (0, 0, 0, pad)) for a in (q, k, v))
            # the tail steps are the identity: i = 0 (no write), f = 1
            # (state kept), so the carried state stays exact
            log_i = F.pad(log_i, (0, pad), value=-1e30)
            log_f = F.pad(log_f, (0, pad))
        init = None if state is None else (state["C"], state["n"], state["m"])
        hout, (C, n, m) = _mlstm_chunk_scan(q, k, v, log_i, log_f, chunk,
                                            init=init)
        hout = hout[:, :, :t]
    else:
        # one step: C ← f·C + i·v kᵀ; h = q·C / max(|q·n|, e^{−m})
        if state is None:
            state = mlstm_init_state(cfg, b, x.dtype, x.device)
        C, n, m = state["C"], state["n"], state["m"]
        lit, lft = log_i[..., 0], log_f[..., 0]
        m_new = torch.maximum(lft + m, lit)
        fw = torch.exp(lft + m - m_new)[..., None]
        iw = torch.exp(lit - m_new)[..., None]
        kt, vt, qt = k[:, :, 0], v[:, :, 0], q[:, :, 0]
        C = C * fw[..., None] + iw[..., None] * kt[..., :, None] \
            * vt[..., None, :]
        n = n * fw + iw * kt
        num = torch.einsum("bhd,bhde->bhe", qt, C) * (dh ** -0.5)
        den = torch.maximum(torch.abs(torch.einsum("bhd,bhd->bh", qt, n))
                            * (dh ** -0.5), torch.exp(-m_new))
        hout = (num / den[..., None])[:, :, None]               # (B, H, 1, dh)
        m = m_new
    new_state = {"C": C, "n": n, "m": m, "conv": conv_state}
    hout = hout.permute(0, 2, 1, 3).reshape(b, t, di).to(x.dtype)
    hout = apply_norm(p["gn"], hout, "rms")
    return dense(p["down"], hout * F.silu(x2)), new_state


def mlstm_init_state(cfg: ArchConfig, batch: int, dtype, device) -> Params:
    di = int(cfg.d_model * cfg.expand)
    h = cfg.n_heads
    dh = di // h
    return {
        "C": torch.zeros((batch, h, dh, dh), dtype=_F32, device=device),
        "n": torch.zeros((batch, h, dh), dtype=_F32, device=device),
        "m": torch.full((batch, h), -1e30, dtype=_F32, device=device),
        "conv": torch.zeros((batch, cfg.conv_width - 1, di), dtype=dtype,
                            device=device),
    }


# ---------------------------------------------------------------- sLSTM
_GATES = ("i", "f", "z", "o")


def slstm_block_init(gen: torch.Generator, cfg: ArchConfig, dtype,
                     device) -> Params:
    d = cfg.d_model
    h = cfg.n_heads
    dh = d // h
    p: Params = {"gn": norm_init(d, "rms", dtype, device)}
    for g in _GATES:
        p[f"w_{g}"] = dense_init(gen, d, d, dtype, device)
    for g in _GATES:
        # block-diagonal recurrent weights: (H, dh, dh)
        p[f"r_{g}"] = normal_init(gen, (h, dh, dh), dh ** -0.5, dtype, device)
    p["f_bias"] = torch.full((d,), 3.0, dtype=_F32, device=device)
    dff = int(d * 4 / 3)
    p["ffn_gate"] = dense_init(gen, d, dff, dtype, device)
    p["ffn_up"] = dense_init(gen, d, dff, dtype, device)
    p["ffn_down"] = dense_init(gen, dff, d, dtype, device)
    return p


def slstm_block_apply(p: Params, x: torch.Tensor, cfg: ArchConfig,
                      state: Optional[Params] = None
                      ) -> Tuple[torch.Tensor, Params]:
    """A loop over time (memory mixing forbids a parallel form);
    state {"h", "c", "n", "m"} of (B, D) in the model dtype."""
    b, t, d = x.shape
    h = cfg.n_heads
    dh = d // h
    wx = {g: dense(p[f"w_{g}"], x).to(_F32) for g in _GATES}
    wx["f"] = wx["f"] + p["f_bias"]
    rw = {g: p[f"r_{g}"].to(_F32) for g in _GATES}
    if state is None:
        hp = torch.zeros((b, d), dtype=_F32, device=x.device)
        cp = torch.zeros_like(hp)
        np_ = torch.ones_like(hp)
        mp = torch.zeros_like(hp)
    else:
        hp, cp, np_, mp = (state[s].to(_F32) for s in ("h", "c", "n", "m"))

    def rmul(w, hv):    # block-diagonal recurrent product: (B, d)×(H, dh, dh)
        return torch.einsum("bhd,hde->bhe", hv.reshape(b, h, dh),
                            w).reshape(b, d)

    hs = []
    for s in range(t):
        it = wx["i"][:, s] + rmul(rw["i"], hp)
        ft = wx["f"][:, s] + rmul(rw["f"], hp)
        zt = torch.tanh(wx["z"][:, s] + rmul(rw["z"], hp))
        ot = torch.sigmoid(wx["o"][:, s] + rmul(rw["o"], hp))
        lf = F.logsigmoid(ft)
        mt = torch.maximum(lf + mp, it)
        iw = torch.exp(it - mt)
        fw = torch.exp(lf + mp - mt)
        cp = fw * cp + iw * zt
        np_ = fw * np_ + iw
        hp = ot * cp / torch.clamp(np_, min=1.0)
        mp = mt
        hs.append(hp)
    hout = torch.stack(hs, dim=1).to(x.dtype)                   # (B, T, D)
    hout = apply_norm(p["gn"], hout, "rms")
    y = F.silu(dense(p["ffn_gate"], hout)) * dense(p["ffn_up"], hout)
    new_state = {"h": hp.to(x.dtype), "c": cp.to(x.dtype),
                 "n": np_.to(x.dtype), "m": mp.to(x.dtype)}
    return dense(p["ffn_down"], y), new_state


def slstm_init_state(cfg: ArchConfig, batch: int, dtype, device) -> Params:
    d = cfg.d_model
    return {s: (torch.ones if s == "n" else torch.zeros)(
        (batch, d), dtype=dtype, device=device) for s in ("h", "c", "n", "m")}
