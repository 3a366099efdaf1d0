"""Serving launcher: batched generation for a dense ``--arch``, optional
kNN-LM retrieval backed by the PGBJ join. PyTorch port of the JAX
package's ``launch.serve``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-3b \\
      [--reduced] [--requests 8] [--new-tokens 16] [--retrieval]

Runs on the card (bf16 at full width, float32 with ``--reduced``);
``--device cpu`` runs the plain PyTorch versions of the kernels.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import ARCH_IDS, get_arch, get_reduced
from ..device import resolve_device
from ..models import ModelOptions, init_params
from ..serve import (BatchedServer, Datastore, KnnLMConfig, ServeConfig,
                     interpolate, knn_logits)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--retrieval", action="store_true")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_reduced(args.arch) if args.reduced else get_arch(args.arch)
    opts = ModelOptions(dtype=torch.float32 if args.reduced
                        else torch.bfloat16)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         opts, device=dev)
    rng = np.random.default_rng(0)

    hook = None
    if args.retrieval:
        keys = rng.normal(size=(2048, 32)).astype(np.float32)
        vals = rng.integers(0, cfg.vocab, 2048).astype(np.int32)
        store = Datastore.build(keys, vals, k=8, n_pivots=128, n_groups=8,
                                device=dev)
        kcfg = KnnLMConfig(lam=0.2, tau=50.0, k=8)

        def hook(logits, cache):
            q = logits[:, :32].to(torch.float32).cpu().numpy()
            return interpolate(logits, knn_logits(q, store, kcfg, cfg.vocab),
                               kcfg.lam)

    srv = BatchedServer(
        cfg, ServeConfig(batch=args.batch, temperature=args.temperature),
        params, opts, logits_hook=hook)
    prompts = [rng.integers(0, cfg.vocab, int(rng.integers(4, 16)))
               for _ in range(args.requests)]
    t0 = time.time()
    outs = srv.generate(prompts, max_new_tokens=args.new_tokens)
    dt = time.time() - t0
    total = sum(len(o) for o in outs)
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "cpu")
    print(f"{args.requests} requests × {args.new_tokens} tokens in {dt:.2f}s"
          f" ({total/dt:.1f} tok/s) on {where}"
          f"{' with kNN-LM retrieval' if hook else ''}")
    for i, o in enumerate(outs[:4]):
        print(f"  req {i}: {list(o)[:10]}{'…' if len(o) > 10 else ''}")
    return outs


if __name__ == "__main__":
    main()
