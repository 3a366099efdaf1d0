"""Serving launcher: batched generation for any ``--arch`` that
``BatchedServer`` serves (every one but whisper-small, whose decoder
needs the encoder's output: serve it through ``make_serve_step`` with
``enc_out=``), optional kNN-LM retrieval backed by the PGBJ join.
PyTorch port of the JAX package's ``launch.serve``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-3b \\
      [--reduced] [--requests 8] [--new-tokens 16] [--retrieval]
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch deepseek-v2-lite-16b --reduced --device cpu --retrieval

Runs on the card (bf16 at full width, float32 with ``--reduced``);
``--device cpu`` runs the plain PyTorch versions of the kernels.

``--tp N`` serves one tensor-parallel replica of a dense decoder, or of
a MoE one (deepseek-v2-lite-16b, arctic-480b: experts and MLA's heads
split), over N model shards (``distributed.tensor_parallel``; an N that
does not split the arch raises): on N cards, or on the
devices ``--devices`` lists (N entries; ``cuda:0,cuda:0`` puts two
shards on one card, ``cpu,cpu`` two on the CPU) — nothing falls back to
one device. Its whole tree is drawn on the CPU from the same seed (the
one-device launcher's with ``--device cpu``) and only each shard's part
reaches its device, so a model larger than one card starts:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-3b \
      --reduced --tp 2 --devices cpu,cpu --retrieval
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch deepseek-v2-lite-16b --reduced --tp 2 --devices cpu,cpu
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import ARCH_IDS, get_arch, get_reduced
from ..device import resolve_device
from ..distributed import LocalComm, make_mesh
from ..distributed.tensor_parallel import shard_params_tp
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
    ap.add_argument("--tp", type=int, default=1,
                    help="model shards of the tensor-parallel replica")
    ap.add_argument("--devices", default=None,
                    help="with --tp: the shards' devices, comma-separated "
                         "(default: --tp cards)")
    args = ap.parse_args(argv)

    cfg = get_reduced(args.arch) if args.reduced else get_arch(args.arch)
    if cfg.n_enc_layers:
        ap.error(f"{args.arch} is an encoder-decoder arch: BatchedServer "
                 f"passes no encoder output; serve it through "
                 f"serve.make_serve_step with enc_out=models.encode(...)")
    comm = mesh = None
    if args.tp > 1:
        mesh = make_mesh((1, args.tp), ("data", "model"), devices=None
                         if args.devices is None
                         else args.devices.split(","))
        comm = LocalComm(mesh).axis("model")
        dev = mesh.devices[0]
    elif args.devices is not None:
        ap.error("--devices places the shards of --tp N > 1")
    else:
        dev = resolve_device(args.device)
    opts = ModelOptions(dtype=torch.float32 if args.reduced
                        else torch.bfloat16)
    # over a model axis the whole tree is drawn on the CPU, and only each
    # shard's part reaches its device
    home = torch.device("cpu") if mesh is not None else dev
    params = init_params(cfg, torch.Generator(device=home).manual_seed(0),
                         opts, device=home)
    if mesh is not None:
        params = shard_params_tp(params, cfg, mesh)
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
        params, opts, logits_hook=hook, comm=comm)
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
          f"{f' over {args.tp} model shards' if comm else ''}"
          f"{' with kNN-LM retrieval' if hook else ''}")
    for i, o in enumerate(outs[:4]):
        print(f"  req {i}: {list(o)[:10]}{'…' if len(o) > 10 else ''}")
    return outs


if __name__ == "__main__":
    main()
