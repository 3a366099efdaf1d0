"""Symmetric per-tile int8 quantization of the packed S rows, with
per-row reconstruction-error bounds — the JAX package's
``quant.quantize``, kept on numpy so codes, scales and ε are the
reference's bits.

Each ``bn``-row tile of the pivot-sorted packed layout is quantized
symmetrically to int8 — one float32 scale per tile, codes in [-127, 127]
— and every row carries an upper bound ε on its reconstruction error
``‖s − ŝ‖₂`` (ŝ = code · scale). By the triangle inequality, for any
query q: |d(q, ŝ) − d(q, s)| ≤ ‖s − ŝ‖ ≤ ε, so ``d(q, ŝ) − ε`` is a
certified lower bound on the true distance and a coarse pass over the
codes can prune and shortlist without losing a true neighbor. ε is
computed in float64 against the float32 scale used at serve time (the
exact ``codes·scale``, never a float32 ŝ), then rounded *up* into
float16 storage. This is build-time host work.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["QuantizedRows", "quantize_rows", "quantize_queries_np",
           "resident_extra_bytes"]


def resident_extra_bytes(n_rows: int, dim: int) -> int:
    """Device bytes of the resident re-rank variant on top of the int8
    codes: the fp32 packed rows (4·dim B/row) plus an int64 global id
    (8 B/row). The quant engine compares this against
    ``REPRO_QUANT_RESIDENT_MAX_BYTES`` to pick resident vs host-gather."""
    return int(n_rows) * (4 * int(dim) + 8)


@dataclasses.dataclass
class QuantizedRows:
    """Int8 codes + per-tile scales + per-row error bounds for one packed
    row block, padded to a whole number of ``bn``-row tiles (padding rows
    are exact zeros: code 0, ε 0 — engines mask them via liveness)."""

    q: np.ndarray        # (n_tiles * bn, dim) int8 codes, packed layout
    scales: np.ndarray   # (n_tiles,) float32 — one symmetric scale per tile
    eps: np.ndarray      # (n_tiles * bn,) float16 — ‖s − ŝ‖₂ rounded UP
    bn: int              # rows per tile
    n_rows: int          # real rows (pre-padding)

    @property
    def n_tiles(self) -> int:
        return int(self.scales.shape[0])

    @property
    def dim(self) -> int:
        return int(self.q.shape[1])

    def nbytes(self) -> int:
        """Resident bytes of the compressed representation (codes +
        scales + error bounds)."""
        return int(self.q.nbytes + self.scales.nbytes + self.eps.nbytes)

    def dequantized(self, dtype=np.float32) -> np.ndarray:
        """The reconstruction ŝ = codes·scale (padded layout). In
        ``float64`` it is exact and is what ε bounds; a float32 ŝ rounds
        each product once more, which ε does not cover."""
        s = np.repeat(self.scales, self.bn).astype(dtype)
        return self.q.astype(dtype) * s[:, None]


def _round_up_f16(x64: np.ndarray) -> np.ndarray:
    """float64 → float16, rounded toward +inf so the stored bound can
    only be looser than the exact one."""
    x16 = x64.astype(np.float16)
    lossy = x16.astype(np.float64) < x64
    return np.where(lossy, np.nextafter(x16, np.float16(np.inf)), x16)


def quantize_rows(rows: np.ndarray, bn: int) -> QuantizedRows:
    """Quantize ``(n, dim)`` float32 rows per ``bn``-row tile.

    Symmetric: scale = amax(|tile|)/127 (1.0 for an all-zero tile),
    code = round(row / scale) clipped to [-127, 127]. ε per row is the
    exact float64 ‖s − ŝ‖₂ against the float32 scale, rounded up into
    float16.
    """
    rows = np.ascontiguousarray(rows, np.float32)
    if bn < 1:
        raise ValueError("bn must be >= 1")
    n, dim = rows.shape
    n_tiles = max(1, -(-n // bn))
    pad = n_tiles * bn - n
    r = np.pad(rows, ((0, pad), (0, 0))) if pad else rows
    tiles = r.reshape(n_tiles, bn, dim)
    amax = np.abs(tiles).max(axis=(1, 2))
    scales = np.where(amax > 0, amax / np.float32(127.0),
                      np.float32(1.0)).astype(np.float32)
    codes = np.clip(np.rint(tiles / scales[:, None, None]),
                    -127, 127).astype(np.int8)
    recon = codes.astype(np.float64) * scales.astype(np.float64)[:, None, None]
    err = np.sqrt(((tiles.astype(np.float64) - recon) ** 2).sum(axis=2))
    eps = _round_up_f16(err.reshape(n_tiles * bn)).astype(np.float16)
    return QuantizedRows(q=np.ascontiguousarray(codes.reshape(-1, dim)),
                         scales=scales, eps=eps, bn=int(bn), n_rows=int(n))


def quantize_queries_np(q: np.ndarray):
    """Per-row symmetric int8 quantization of a query batch (the numpy
    twin of the engine's in-step ``quantize_queries``).

    Returns ``(codes int8 (n, dim), scales f32 (n,), eps f32 (n,))``
    with ε = ‖q − q̂‖₂ computed in float64 and rounded up.
    """
    q = np.ascontiguousarray(q, np.float32)
    amax = np.abs(q).max(axis=1)
    scales = np.where(amax > 0, amax / np.float32(127.0),
                      np.float32(1.0)).astype(np.float32)
    codes = np.clip(np.rint(q / scales[:, None]), -127, 127).astype(np.int8)
    recon = codes.astype(np.float64) * scales.astype(np.float64)[:, None]
    err = np.sqrt(((q.astype(np.float64) - recon) ** 2).sum(axis=1))
    eps32 = err.astype(np.float32)
    lossy = eps32.astype(np.float64) < err
    eps32 = np.where(lossy, np.nextafter(eps32, np.float32(np.inf)), eps32)
    return codes, scales, eps32.astype(np.float32)
