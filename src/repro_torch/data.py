"""The paper's §6 datasets as seeded numpy generators: Forest-like and
OSM-like rows, the clustered blobs of the tests and kernel benches, and
the paper's frequency-rank expansion behind "Forest×t". Each gives the
same rows for the same seed as the JAX package's ``data.pipeline``."""
from __future__ import annotations

import numpy as np

__all__ = ["clustered_like", "expand_dataset", "forest_like", "osm_like"]


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


def clustered_like(n: int, dim: int, seed: int, *, n_centers: int = 16,
                   centers_seed: int = 42) -> np.ndarray:
    """Gaussian blobs around shared uniform centers in [-20, 20]^dim.
    ``centers_seed`` fixes the centers independently of ``seed``, so R
    and S drawn with different seeds share cluster structure — the
    regime where the paper's bounds bite (kNN radius ≪ diameter)."""
    centers = np.random.default_rng(centers_seed).uniform(
        -20, 20, (n_centers, dim)).astype(np.float32)
    rng = np.random.default_rng(seed)
    who = rng.integers(0, n_centers, n)
    return (centers[who] + rng.normal(size=(n, dim))).astype(np.float32)


def osm_like(n: int, seed: int = 0) -> np.ndarray:
    """2-d lon/lat-like point cloud: dense cities + sparse countryside."""
    rng = np.random.default_rng(seed)
    n_city = int(n * 0.7)
    cities = rng.uniform(-180, 180, (64, 2)) * np.array([1.0, 0.45])
    who = rng.integers(0, 64, n_city)
    urban = cities[who] + rng.normal(size=(n_city, 2)) * 0.5
    rural = np.stack([rng.uniform(-180, 180, n - n_city),
                      rng.uniform(-81, 81, n - n_city)], 1)
    return np.concatenate([urban, rural]).astype(np.float32)


def expand_dataset(data: np.ndarray, factor: int, seed: int = 0
                   ) -> np.ndarray:
    """The paper's §6 expansion ("Forest×t"): copy ``t`` replaces each
    value, per dimension, by the value ``t`` places further along the
    values sorted by ascending frequency (distribution-preserving).
    ``seed`` is accepted for the JAX package's signature; the expansion
    draws nothing."""
    if factor <= 1:
        return data
    out = [data]
    dim = data.shape[1]
    orders = []
    for d in range(dim):
        vals, counts = np.unique(data[:, d], return_counts=True)
        orders.append(vals[np.argsort(counts, kind="stable")])
    for t in range(1, factor):
        new = np.empty_like(data)
        for d in range(dim):
            srt = orders[d]
            idx = np.searchsorted(srt, data[:, d])
            idx = np.minimum(idx + t, len(srt) - 1)   # value ranked next
            new[:, d] = srt[idx]
        out.append(new)
    return np.concatenate(out, axis=0)
