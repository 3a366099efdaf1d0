"""End-to-end training on the PyTorch port: a ~100M-param
llama-family model for a few hundred steps on synthetic data with
checkpoint/restart. The port's twin of ``examples/train_lm.py``.

Run:  PYTHONPATH=src python examples/train_lm_torch.py --steps 300
      (add --restart to resume from the last checkpoint; --device cpu
      runs the kernels' plain PyTorch versions)

float32 without remat, as the JAX script: on the card attention runs K-F
with its lse and K-F's backward K-B, both on their float32 CUDA-core
route (head width 64). ``--layers`` and ``--vocab`` shrink the model for
a CPU test.
"""
import argparse
import dataclasses
import os
import tempfile
import time

import torch

from repro_torch.configs import get_arch
from repro_torch.data import DataConfig, synthetic_lm_batch
from repro_torch.device import resolve_device
from repro_torch.models import ModelOptions, count_params, init_params
from repro_torch.train import OptConfig, TrainConfig, checkpoint, \
    make_train_step


def small_llama(n_layers: int = 12, vocab: int = 32000):
    """~100M-param llama3-family config (same code path as llama3.2-3b)."""
    base = get_arch("llama3.2-3b")
    return dataclasses.replace(
        base, name="llama-100m", n_layers=n_layers, d_model=768, n_heads=12,
        n_kv_heads=4, d_ff=2048, vocab=vocab)


def main(argv=None) -> dict:
    """Runs the loop; returns the numbers it prints (each step's loss, lr
    and grad norm, the step it started from, the checkpoints written) and
    the final parameters."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--restart", action="store_true")
    ap.add_argument("--layers", type=int, default=12)
    ap.add_argument("--vocab", type=int, default=32000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = small_llama(args.layers, args.vocab)
    opts = ModelOptions(dtype=torch.float32, remat=False)
    tcfg = TrainConfig(opt=OptConfig(lr=1e-3, warmup_steps=30,
                                     decay_steps=args.steps), accum=1)
    opt_init, step_fn = make_train_step(cfg, tcfg, opts)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         opts, device=dev)
    n_params = count_params(params)
    print(f"model {cfg.name}: {n_params / 1e6:.1f}M params on {dev}")
    opt = opt_init(params)
    start = 0
    if args.restart and checkpoint.latest_step(args.ckpt_dir) is not None:
        restored, start = checkpoint.restore(args.ckpt_dir,
                                             {"params": params, "opt": opt})
        params, opt = restored["params"], restored["opt"]
        print(f"restored checkpoint at step {start}")

    dcfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                      global_batch=args.batch)
    out = dict(n_params=n_params, start=start, loss=[], lr=[],
               grad_norm=[], tok_s=[], checkpoints=[])
    # each step's metrics stay on the device; they are read in one copy
    # every 20 steps and at the end, as the JAX script reads its own
    pending = []

    def read_metrics():
        if pending:
            rows = torch.stack([torch.stack([m["loss"], m["lr"],
                                             m["grad_norm"]])
                                for m in pending]).tolist()
            for name, col in zip(("loss", "lr", "grad_norm"), zip(*rows)):
                out[name].extend(col)
            pending.clear()

    t0 = time.time()
    for i in range(start, args.steps):
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in synthetic_lm_batch(dcfg, i).items()}
        params, opt, m = step_fn(params, opt, batch)
        pending.append(m)
        if (i + 1) % 20 == 0:
            read_metrics()
            tok_s = args.batch * args.seq * 20 / (time.time() - t0)
            t0 = time.time()
            out["tok_s"].append(tok_s)
            print(f"step {i + 1:4d}  loss {out['loss'][-1]:.4f}  "
                  f"lr {out['lr'][-1]:.2e}  gnorm {out['grad_norm'][-1]:.2f}"
                  f"  {tok_s:.0f} tok/s")
        if (i + 1) % args.ckpt_every == 0:
            path = checkpoint.save(args.ckpt_dir, i + 1,
                                   {"params": params, "opt": opt})
            out["checkpoints"].append(i + 1)
            print(f"checkpoint → {path}")
    read_metrics()
    print("done")
    out["params"] = params
    return out


if __name__ == "__main__":
    main()
