"""Error-bounded quantized index tier: int8 coarse scan + exact fp32
re-rank — PyTorch port of the JAX package's ``quant``. The
representation is in ``quant.quantize``, the two-tier engine in
``quant.engine`` (``QuantMegastepEngine``), the tuning table in
``quant.autotune``."""
from .quantize import (QuantizedRows, quantize_queries_np, quantize_rows,
                       resident_extra_bytes)

__all__ = ["QuantizedRows", "quantize_rows", "quantize_queries_np",
           "resident_extra_bytes"]
