"""The LM substrate, PyTorch port of the JAX package's ``models`` — every
family: the layer stack walked in a Python loop, attention (GQA, MLA,
local over a ring cache, cross-attention) on the flash attention kernel
K-F, the MoE FFN in ``models.moe``, the recurrent cells in
``models.recurrent``."""
from .convert import opt_state_from_jax, params_from_jax
from .model import (ModelOptions, count_params, encode, forward, init_cache,
                    init_params, layer_kinds)

__all__ = ["ModelOptions", "count_params", "encode", "forward", "init_cache",
           "init_params", "layer_kinds", "opt_state_from_jax",
           "params_from_jax"]
