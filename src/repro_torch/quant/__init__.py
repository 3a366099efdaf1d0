"""Error-bounded quantized index tier: int8 coarse scan + exact fp32
re-rank — PyTorch port of the JAX package's ``quant``. The
representation is in ``quant.quantize``, the two-tier engine and its
sharded form in ``quant.engine`` (``QuantMegastepEngine``,
``ShardedQuantMegastepEngine``), the tuning table in
``quant.autotune``."""
from .quantize import (QuantizedRows, quantize_queries_np, quantize_rows,
                       resident_extra_bytes)

__all__ = ["QuantizedRows", "quantize_rows", "quantize_queries_np",
           "resident_extra_bytes", "QuantMegastepEngine",
           "ShardedQuantMegastepEngine", "quantize_queries"]

_ENGINE = ("QuantMegastepEngine", "ShardedQuantMegastepEngine",
           "quantize_queries")


def __getattr__(name):
    # the engines import ``core``, which imports this package's
    # ``quantize``: they load on first use, after both packages
    if name in _ENGINE:
        from . import engine
        return getattr(engine, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
