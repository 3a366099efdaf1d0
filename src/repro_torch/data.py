"""Seeded numpy data: the LM training stream (``DataConfig``,
``synthetic_lm_batch``, ``batch_iterator``), the paper's §6 datasets
(Forest-like and OSM-like rows), the clustered blobs of the tests and
kernel benches, and the paper's frequency-rank expansion behind
"Forest×t". Each gives the same arrays for the same seed as the JAX
package's ``data.pipeline``.

The LM stream is stateless: every batch is a pure function of (seed,
step, shard), so a restart from any checkpoint replays the exact stream
with no iterator state to persist."""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np

__all__ = ["DataConfig", "batch_iterator", "clustered_like",
           "expand_dataset", "forest_like", "osm_like",
           "synthetic_lm_batch"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_shards: int = 1
    shard: int = 0


def synthetic_lm_batch(cfg: DataConfig, step: int) -> Dict[str, np.ndarray]:
    """Markov token stream: 3/4 of rows follow a fixed random successor
    table (a function of cfg.seed only — learnable across steps), 1/4 are
    uniform noise. Optimal loss ≈ 0.25·ln(V): plenty of headroom for
    loss-decreases tests while keeping an irreducible component."""
    assert cfg.global_batch % cfg.n_shards == 0
    b = cfg.global_batch // cfg.n_shards
    table_rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, 7]))
    successor = table_rng.permutation(cfg.vocab)
    rng = np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, cfg.shard]))
    base = rng.integers(0, cfg.vocab, (b, cfg.seq_len + 1), dtype=np.int64)
    chain = np.empty((b, cfg.seq_len + 1), np.int64)
    chain[:, 0] = rng.integers(0, cfg.vocab, b)
    for t in range(1, cfg.seq_len + 1):
        chain[:, t] = successor[chain[:, t - 1]]
    use_chain = rng.random((b, 1)) < 0.75
    toks = np.where(use_chain, chain, base)
    return {"tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32)}


def batch_iterator(cfg: DataConfig, start_step: int = 0
                   ) -> Iterator[Dict[str, np.ndarray]]:
    step = start_step
    while True:
        yield synthetic_lm_batch(cfg, step)
        step += 1


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
