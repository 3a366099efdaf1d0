"""Hand-written Hopper kernels of the port (CUDA C++ in ``csrc/``, built
by ``nvcc`` at first use and bound with ``ctypes``), each with its plain
PyTorch version beside it:

- ``distance_topk``: the scheduled gather top-k (megastep stage 4 and
  the host-planned gather reducer) and the dense top-k (the kNN-LM
  brute-force retrieval)
- ``assign``: phase-1 nearest-pivot map (``build_index``,
  ``plan_queries``)
- ``quant_topk``: the quantized tier's int8 coarse scan
- ``flash_attention``: the LM's attention forward (prefill and decode)

``ops`` dispatches on the tensors' device and reads the launch counts.
"""
from . import ops

__all__ = ["ops"]
