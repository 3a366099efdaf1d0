#!/usr/bin/env python3
"""Time the nearest-pivot kernel (K-A) of one checkout at the shapes of the
port's paths, on one NVIDIA GPU.

    python3 tools/bench_assign.py [--src DIR] [--iters N] [--only TEXT]
                                  [--out FILE]

``--src`` is the ``src`` directory of the checkout whose ``repro_torch``
is timed (default: this repository's); its kernels are built there, at
first use. To compare two versions of the kernel, run this script over
each checkout in turns (A, B, B, A) on one card, one after another.
Each shape prints one JSON line: the card's name and power limit, the
shape, the mean CUDA-event ms over ``--iters`` launches after two warm-up
launches (inputs resident, as the paths call it; at a few thousand rows
this is the wrapper's host time), the device time a call (the calls
enqueued while the device spins), the launch's plan where the checkout
has one, and a SHA-256 of the ids' and distances' bytes, which is equal
across two versions exactly when their outputs are bit for bit equal.
Shapes (rows n x pivots M x width d): the Forest build (581,012 x 256 x
10) and a 65,536-row R sample against its pivots, the small batches the
paths hand it (``--small``, default 1,024 / 1,920 / 4,096 rows of Forest
R against those pivots), the kNN-LM datastore build (1,048,576 x 128 x
32, Gaussian) and phase 13's wide shape (65,536 x 256 x 3,072, Gaussian).
The timers and the card line are ``chip_smoke.py``'s. Imports nothing of
JAX."""
from __future__ import annotations

import argparse
import hashlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--small", default="1024,1920,4096",
                    help="row counts of the small batches")
    ap.add_argument("--only", default=None,
                    help="time only the shapes whose name holds this")
    ap.add_argument("--out", default=None, help="append the lines here too")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("bench_assign: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, args.src)
    import repro_torch as rt
    from repro_torch.kernels import assign as ka
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    dev = "cuda"

    s_np = rt.forest_like(581_012, 10, seed=0)
    r_np = rt.forest_like(65_536, 10, seed=1)
    cfg = rt.JoinConfig(k=10, n_pivots=256, tile_r=128, tile_s=512)
    piv = torch.as_tensor(rt.core.select_pivots(
        s_np, cfg.n_pivots, cfg.pivot_strategy, sample=cfg.pivot_sample,
        n_sets=cfg.pivot_candidate_sets, seed=cfg.seed, device=dev),
        device=dev)
    s = torch.as_tensor(s_np, device=dev)
    r = torch.as_tensor(r_np, device=dev)
    gen = torch.Generator(device=dev).manual_seed(18)
    cases = [("forest build", s, piv), ("forest R 65,536", r, piv)]
    cases += [(f"forest R {n:,}", r[:n].contiguous(), piv)
              for n in map(int, args.small.split(","))]
    cases.append(("LM datastore build", torch.randn(
        (1_048_576, 32), generator=gen, device=dev), torch.randn(
        (128, 32), generator=gen, device=dev)))
    cases.append(("d = 3,072", torch.randn((65_536, 3072), generator=gen,
                                           device=dev),
                  torch.randn((256, 3072), generator=gen, device=dev)))
    lines = []
    for what, x, p in cases:
        if args.only and args.only not in what:
            continue
        pid, dist = ka.assign_cuda(x, p)
        torch.cuda.synchronize()
        plan = getattr(ka, "last_assign_plan", None)
        sha = hashlib.sha256(pid.cpu().numpy().tobytes()
                             + dist.cpu().numpy().tobytes()).hexdigest()[:16]
        line = json.dumps(dict(
            card=card, src=args.src, shape=what, n=x.shape[0], m=p.shape[0],
            d=x.shape[1],
            ms=cs.time_ms(lambda: ka.assign_cuda(x, p), iters=args.iters),
            device_ms=cs.device_ms(torch, lambda: ka.assign_cuda(x, p),
                                   iters=args.iters),
            plan=None if plan is None else plan._asdict(), sha=sha))
        print(line, flush=True)
        lines.append(line)
    if args.out:
        with open(args.out, "a") as f:
            f.write("".join(ln + "\n" for ln in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
