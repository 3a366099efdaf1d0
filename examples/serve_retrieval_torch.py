"""Serving with kNN-LM retrieval on the PyTorch port: the paper's join as
a serving feature. The port's twin of ``examples/serve_retrieval.py``.

A small LM serves batched requests; at each decode step the batch's
logits are joined (R ⋉ S, |R| = batch) against a datastore of key
embeddings using the PGBJ machinery, and the retrieval distribution is
interpolated with the LM head.

The datastore is mutable while it serves: between request waves new
(key, value) pairs are ingested with ``add_entries`` (they seal into a
delta segment — S-side phase 1 never re-runs on the existing base),
stale ones are tombstoned with ``remove_entries``, and ``compact()``
folds everything back into one base between decode steps.

Retrieval runs through a ``ServeScheduler`` (admission control +
deadlines), so the metrics registry (``repro_torch.obs.metrics.REGISTRY``)
fills up as the demo serves — a live summary (qps, p99, shed/degraded
fractions, the paper's pruning selectivity) prints at exit.

Run:  PYTHONPATH=src python examples/serve_retrieval_torch.py [--device cpu]

Runs on the card (attention on K-F, the datastore's phase 1 on K-A and
each decode step's join on K-G); ``--device cpu`` runs the kernels' plain
PyTorch versions.
"""
import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import obs
from repro_torch.configs import get_reduced
from repro_torch.device import resolve_device
from repro_torch.models import ModelOptions, forward, init_params
from repro_torch.serve import (BatchedServer, Datastore, KnnLMConfig,
                               ServeConfig, ServeScheduler, make_knn_hook)


def main(argv=None) -> dict:
    """Serves the waves and updates the store; returns the numbers it
    prints."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = dataclasses.replace(get_reduced("llama3.2-3b"), vocab=512)
    opts = ModelOptions(dtype=torch.float32, remat=False)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         opts, device=dev)
    rng = np.random.default_rng(0)

    def logit_keys(corpus):
        # as the JAX script: the leading 64 logit columns of each context
        # stand in for the model's hidden state
        hs, _ = forward(params, cfg, torch.as_tensor(corpus, device=dev),
                        opts=opts)
        return hs[:, :-1].reshape(-1, cfg.vocab)[:, :64].cpu().numpy()

    # build a datastore of (context → next token) pairs from a "corpus"
    corpus = rng.integers(0, cfg.vocab, (64, 48), dtype=np.int32)
    keys = logit_keys(corpus)                  # (N, 64)
    vals = corpus[:, 1:].reshape(-1)
    # S-side phase 1 runs once here; each decode step's batch is planned
    # fresh against the resident index
    store = Datastore.build(keys, vals, k=8, n_pivots=64, n_groups=4,
                            device=dev)
    kcfg = KnnLMConfig(lam=0.3, tau=100.0, k=8)
    # retrieval through admission control: every decode step's join is a
    # scheduled request, so the metrics registry sees real serving traffic
    sched = ServeScheduler.for_datastore(store, kcfg.k)
    t_serve0 = time.perf_counter()
    hook = make_knn_hook(store, kcfg, cfg.vocab, scheduler=sched,
                         deadline_s=5.0)

    srv = BatchedServer(cfg, ServeConfig(batch=4, temperature=0.0),
                        params, opts, logits_hook=hook)
    prompts = [rng.integers(0, cfg.vocab, rng.integers(4, 12))
               for _ in range(6)]
    outs = srv.generate(prompts, max_new_tokens=8)
    for i, (p, o) in enumerate(zip(prompts, outs)):
        print(f"req {i}: prompt={p.tolist()[:6]}… → {o.tolist()}")
    print(f"\nserved 6 requests in 2 batched waves with kNN-LM retrieval "
          f"on {dev} ✓")
    print(f"datastore: {store.n_entries} live entries, "
          f"{store.config.n_pivots} pivots, {store.config.n_groups} groups")

    # --- online update between waves: ingest a fresh corpus chunk and
    # retire the oldest entries — no phase-1 re-run on existing segments
    corpus2 = rng.integers(0, cfg.vocab, (16, 48), dtype=np.int32)
    ids = store.add_entries(logit_keys(corpus2), corpus2[:, 1:].reshape(-1))
    store.remove_entries(np.arange(128))        # oldest 128 pairs
    n_segments, n_tombstones = store.index.n_segments, \
        store.index.n_tombstones
    print(f"after update: {store.n_entries} live entries in "
          f"{n_segments} segments ({n_tombstones} tombstones), "
          f"new ids {ids[0]}..{ids[-1]}")

    outs2 = srv.generate(prompts[:2], max_new_tokens=8)
    print("re-served 2 requests against the updated store ✓")

    store.compact()                             # between decode steps
    print(f"compacted to {store.index.n_segments} segment, "
          f"{store.n_entries} live entries "
          f"({store.index.last_compact_s * 1e3:.1f} ms)")

    # --- live metrics summary: what the metrics registry saw ----------
    elapsed = time.perf_counter() - t_serve0
    st = sched.snapshot()
    ms = obs.metrics.REGISTRY.snapshot()
    qps = st.n_completed / max(elapsed, 1e-9)
    shed_frac = st.n_shed / max(st.n_submitted, 1)
    degraded_frac = st.n_degraded_requests / max(st.n_completed, 1)
    p50 = ms.get("serve_latency_s_p50", float("nan"))
    p99 = ms.get("serve_latency_s_p99", float("nan"))
    print("\n-- serving metrics (repro_torch.obs) --")
    print(f"requests: {st.n_submitted} submitted, "
          f"{st.n_completed} completed ({qps:.1f} req/s), "
          f"{st.n_retries} retries, {st.n_failovers} failovers")
    print(f"latency: p50={p50 * 1e3:.2f}ms p99={p99 * 1e3:.2f}ms")
    print(f"shed fraction: {shed_frac:.3f}, "
          f"degraded fraction: {degraded_frac:.3f}")
    print(f"pruning: selectivity={st.join.selectivity:.4f} (Eq. 13), "
          f"tile selectivity={st.join.tile_selectivity:.3f} "
          f"({st.join.tiles_visited}/{st.join.tiles_total} tiles), "
          f"index compactions="
          f"{int(ms.get('index_compact_total', 0))}")
    return dict(tokens=[o.tolist() for o in outs],
                tokens_reserved=[o.tolist() for o in outs2],
                n_entries=store.n_entries, n_segments=n_segments,
                n_tombstones=n_tombstones, n_submitted=st.n_submitted,
                n_completed=st.n_completed, n_shed=st.n_shed,
                n_degraded=st.n_degraded_requests, n_retries=st.n_retries,
                qps=qps, latency_p50_s=p50, latency_p99_s=p99,
                selectivity=st.join.selectivity,
                tile_selectivity=st.join.tile_selectivity)


if __name__ == "__main__":
    main()
