"""Training launcher: ``--arch <id>`` on one device, PyTorch port of the
JAX package's ``launch.train`` (its flags plus ``--device``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \\
      --steps 100 --seq 512 --batch 16 [--ckpt-dir …] [--restart]
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \\
      --reduced --device cpu --steps 20 --seq 32 --batch 4

bf16 with remat at full width, float32 without remat with ``--reduced``,
AdamW; stateless data replay (``synthetic_lm_batch(dcfg, i)`` for step
i), a checkpoint every ``--ckpt-every`` steps, ``--restart`` from the
latest one. Runs on the card unless ``--device cpu``; one device (the
LM's mesh layout is Queue A6e).
"""
from __future__ import annotations

import argparse
import time

import torch

from ..configs import ARCH_IDS, get_arch, get_reduced
from ..data import DataConfig, synthetic_lm_batch
from ..device import resolve_device
from ..models import ModelOptions, count_params, init_params
from ..train import OptConfig, TrainConfig, checkpoint, make_train_step


def main(argv=None) -> dict:
    """Runs the loop; returns each step's loss, grad norm and host
    seconds (the device synchronised at the end of every step), and the
    step it started from."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-scale config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--restart", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_reduced(args.arch) if args.reduced else get_arch(args.arch)
    dev = resolve_device(args.device)
    opts = ModelOptions(dtype=torch.float32 if args.reduced
                        else torch.bfloat16,
                        remat=not args.reduced,
                        max_abs_pos=max(4096, args.seq))
    tcfg = TrainConfig(opt=OptConfig(lr=args.lr, warmup_steps=10,
                                     decay_steps=args.steps),
                       accum=args.accum)
    opt_init, step_fn = make_train_step(cfg, tcfg, opts)

    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         opts, device=dev)
    opt = opt_init(params)
    print(f"{cfg.name}: {count_params(params) / 1e6:.1f}M params on {dev}",
          flush=True)
    start = 0
    if args.restart and args.ckpt_dir and \
            checkpoint.latest_step(args.ckpt_dir) is not None:
        restored, start = checkpoint.restore(
            args.ckpt_dir, {"params": params, "opt": opt})
        params, opt = restored["params"], restored["opt"]
        print(f"restored step {start}", flush=True)

    dcfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                      global_batch=args.batch * max(1, args.accum))
    out = {"start": start, "loss": [], "grad_norm": [], "step_s": []}
    t0 = time.perf_counter()
    for i in range(start, args.steps):
        t_step = time.perf_counter()
        raw = synthetic_lm_batch(dcfg, i)
        if args.accum > 1:
            raw = {k: v.reshape(args.accum, args.batch, -1)
                   for k, v in raw.items()}
        batch = {k: torch.as_tensor(v, device=dev) for k, v in raw.items()}
        params, opt, m = step_fn(params, opt, batch)
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
        out["step_s"].append(time.perf_counter() - t_step)
        if (i + 1) % 10 == 0:
            print(f"step {i + 1:5d} loss {out['loss'][-1]:.4f} "
                  f"({(time.perf_counter() - t0) / 10:.2f}s/step)",
                  flush=True)
            t0 = time.perf_counter()
        if args.ckpt_dir and (i + 1) % args.ckpt_every == 0:
            checkpoint.save(args.ckpt_dir, i + 1,
                            {"params": params, "opt": opt})
    print("done", flush=True)
    return out


if __name__ == "__main__":
    main()
