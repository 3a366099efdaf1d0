"""The LM substrate, PyTorch port of the JAX package's ``models`` — the
dense family: the layer stack walked in a Python loop, attention on the
flash attention kernel K-F."""
from .convert import params_from_jax
from .model import (ModelOptions, count_params, forward, init_cache,
                    init_params, layer_kinds)

__all__ = ["ModelOptions", "count_params", "forward", "init_cache",
           "init_params", "layer_kinds", "params_from_jax"]
