"""Measured tuning table for the quantized tier — PyTorch port of the JAX
package's ``quant.autotune``.

The int8 coarse pass pays off only when the shortlist ``mp``, the tile
shapes and — above all — the choice to use int8 at all suit the device.
:func:`sweep_config` times the fp32 megastep against the forced-int8
engine across candidate shortlist sizes and returns the winner as a
:class:`TunedConfig`; a :class:`TuningTable` keyed on ``(backend, dim,
n_rows, k)`` persists such decisions as JSON, and
``QuantMegastepEngine`` looks its shape up at construction. An explicit
``quant_slack`` (or ``tune=False``) pins classic int8 behaviour.

The port's table starts empty: the JAX package's ``TUNE_quant.json``
holds measurements of another program on another device, and no sweep
of this port has been recorded yet. The default table is read from
``REPRO_TORCH_QUANT_TUNE_TABLE`` or ``TUNE_quant.json`` beside this
module; a missing file is an empty table.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import time
from typing import Dict, Optional

__all__ = ["TunedConfig", "TuningTable", "table_key", "default_table",
           "default_table_path", "lookup", "sweep_config",
           "reset_default_table"]

_ENV_TABLE = "REPRO_TORCH_QUANT_TUNE_TABLE"


def _next_pow2(n: int) -> int:
    return 1 << max(0, int(n - 1).bit_length())


@dataclasses.dataclass(frozen=True)
class TunedConfig:
    """One measured decision for one (backend, dim, n-bucket, k) cell:
    ``mode="int8"`` (the coarse scan + exact re-rank won; ``mp``/``bm``/
    ``bn`` apply, 0 = engine default) or ``"fp32"`` (run the plain fp32
    megastep). The timing fields document the measurement."""

    mode: str                      # "int8" | "fp32"
    mp: int = 0                    # shortlist size (pow2); 0 = default
    bm: int = 0                    # query-tile rows cap; 0 = default
    bn: int = 0                    # S-tile rows; 0 = config.tile_s
    int8_batch_s: float = math.nan
    fp32_batch_s: float = math.nan

    def __post_init__(self):
        if self.mode not in ("int8", "fp32"):
            raise ValueError(f"mode must be int8|fp32, got {self.mode!r}")
        for name in ("mp", "bm", "bn"):
            v = getattr(self, name)
            if v and v != _next_pow2(v):
                raise ValueError(f"{name} must be a power of two, got {v}")

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "TunedConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


def table_key(dim: int, n_rows: int, k: int, backend: str) -> str:
    """Cells bucket ``n_rows`` to the next power of two."""
    n = _next_pow2(max(1, int(n_rows)))
    return f"{backend}|d{int(dim)}|n{n}|k{int(k)}"


class TuningTable:
    """A {key: TunedConfig} map with JSON round-trip."""

    def __init__(self, entries: Optional[Dict[str, TunedConfig]] = None):
        self.entries: Dict[str, TunedConfig] = dict(entries or {})

    def get(self, dim: int, n_rows: int, k: int,
            backend: str) -> Optional[TunedConfig]:
        return self.entries.get(table_key(dim, n_rows, k, backend))

    def put(self, dim: int, n_rows: int, k: int, backend: str,
            cfg: TunedConfig) -> None:
        self.entries[table_key(dim, n_rows, k, backend)] = cfg

    def to_json(self) -> str:
        body = {k: v.to_dict() for k, v in sorted(self.entries.items())}
        return json.dumps({"version": 1, "entries": body}, indent=2) + "\n"

    @classmethod
    def from_json(cls, text: str) -> "TuningTable":
        doc = json.loads(text)
        return cls({k: TunedConfig.from_dict(v)
                    for k, v in doc.get("entries", {}).items()})

    def save(self, path: str) -> None:
        with open(path, "w") as fh:
            fh.write(self.to_json())

    @classmethod
    def load(cls, path: str) -> "TuningTable":
        with open(path) as fh:
            return cls.from_json(fh.read())


def default_table_path() -> str:
    return os.environ.get(_ENV_TABLE) or os.path.join(
        os.path.dirname(__file__), "TUNE_quant.json")


_DEFAULT: Optional[TuningTable] = None
_DEFAULT_PATH: Optional[str] = None


def default_table() -> TuningTable:
    """The process-wide table, loaded once from :func:`default_table_path`
    (empty if the file is missing or unreadable)."""
    global _DEFAULT, _DEFAULT_PATH
    path = default_table_path()
    if _DEFAULT is None or path != _DEFAULT_PATH:
        try:
            _DEFAULT = TuningTable.load(path)
        except (OSError, ValueError, KeyError):
            _DEFAULT = TuningTable()
        _DEFAULT_PATH = path
    return _DEFAULT


def reset_default_table() -> None:
    """Drop the cached table (after pointing the environment variable
    elsewhere mid-process)."""
    global _DEFAULT, _DEFAULT_PATH
    _DEFAULT = None
    _DEFAULT_PATH = None


def lookup(dim: int, n_rows: int, k: int,
           backend: str) -> Optional[TunedConfig]:
    """The tuned decision for a shape on ``backend`` ("cuda" | "cpu")."""
    return default_table().get(dim, n_rows, k, backend)


def _time_join(engine, q, *, iters: int) -> float:
    best = math.inf
    engine.join_batch(q)                      # warm: payload upload
    for _ in range(iters):
        t0 = time.perf_counter()
        engine.join_batch(q)                  # ends in a fetch (synchronous)
        best = min(best, time.perf_counter() - t0)
    return best


def sweep_config(index, config=None, *, batch: int = 256, iters: int = 3,
                 mps=None, bns=None) -> TunedConfig:
    """Measure fp32-vs-int8 for ``index``'s shape on its device and
    return the winner: the exact fp32 ``MegastepEngine`` against a
    forced-int8 ``QuantMegastepEngine`` (resident re-rank, ``tune=False``)
    for each candidate ``mp`` (and S-tile size), on a deterministic
    query batch drawn from the indexed rows. int8 wins only if strictly
    faster end to end, certification fallbacks included."""
    import numpy as np

    from ..core.megastep import MegastepEngine
    from .engine import QuantMegastepEngine

    cfg = config if config is not None else index.config
    k = cfg.k
    if mps is None:
        lo = _next_pow2(max(2 * k, 16))
        mps = sorted({lo, _next_pow2(4 * k), max(_next_pow2(4 * k), 128)})
    if bns is None:
        bns = (0,)
    rows = index.s_sorted.cpu().numpy()
    if len(rows) == 0:
        raise ValueError("sweep_config needs a built SIndex")
    rng = np.random.default_rng(0)
    sel = rng.integers(0, rows.shape[0], size=min(batch, rows.shape[0]))
    q = np.ascontiguousarray(rows[sel], dtype=np.float32)
    q = q + rng.normal(0, 1e-3, q.shape).astype(np.float32)

    dev = index.device
    fp32_s = _time_join(MegastepEngine(index, cfg, device=dev), q,
                        iters=iters)
    best_s, best_mp, best_bn = math.inf, 0, 0
    for bn in bns:
        for mp in mps:
            eng = QuantMegastepEngine(index, cfg, slack=max(int(mp) - k, 0),
                                      resident=True, tune=False,
                                      tune_bn=int(bn) or None, device=dev)
            t = _time_join(eng, q, iters=iters)
            if t < best_s:
                best_s, best_mp, best_bn = t, int(mp), int(bn)
    mode = "int8" if best_s < fp32_s else "fp32"
    return TunedConfig(mode=mode, mp=best_mp if mode == "int8" else 0,
                       bn=best_bn if mode == "int8" else 0,
                       int8_batch_s=best_s, fp32_batch_s=fp32_s)
