"""Synthetic datasets of the paper's §6 (a numpy copy of the JAX
package's ``data.pipeline.forest_like``: same seed, same rows)."""
from __future__ import annotations

import numpy as np

__all__ = ["forest_like"]


def forest_like(n: int, dim: int = 10, seed: int = 0,
                n_clusters: int = 32) -> np.ndarray:
    """Clustered integer-valued features mimicking Forest CoverType's
    10 integer attributes. Anisotropic like the real dataset: the paper
    (§6.3) observes attributes 6-10 have low variance — effective
    dimensionality is ~5-6, which is where Voronoi pruning still works.
    """
    rng = np.random.default_rng(seed)
    # per-dimension spread decays: first dims dominate distances
    dim_scale = 1.0 / (1.0 + 0.9 * np.arange(dim))
    centers = rng.uniform(0, 1000, (n_clusters, dim)) * dim_scale
    scales = rng.uniform(5, 60, (n_clusters, dim)) * dim_scale
    who = rng.integers(0, n_clusters, n)
    pts = centers[who] + rng.normal(size=(n, dim)) * scales[who]
    return np.round(pts).astype(np.float32)
