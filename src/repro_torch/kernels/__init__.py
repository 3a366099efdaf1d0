"""Hand-written Hopper kernels of the port (CUDA C++ in ``csrc/``, built
by ``nvcc`` at first use and bound with ``ctypes``), each with its plain
PyTorch version beside it:

- ``distance_topk``: the megastep's scheduled gather top-k (stage 4)
- ``assign``: phase-1 nearest-pivot map (``build_index``)

``ops`` dispatches on the tensors' device and reads the launch counts.
"""
from . import ops

__all__ = ["ops"]
