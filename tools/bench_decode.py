#!/usr/bin/env python3
"""Time llama3.2-3b's decode step as ``chip_smoke.py`` phase 14 serves
it, for one checkout, on one NVIDIA GPU.

    python3 tools/bench_decode.py [--src DIR] [--new-tokens N] [--out FILE]

``--src`` is the ``src`` directory of the checkout whose ``repro_torch``
is timed (default: this repository's); its kernels are built there, at
first use. To compare two versions, run this script over each checkout
in turns (A, B, B, A) on one card, one after another. The run is phase
14's first wave without the kNN-LM hook: llama3.2-3b at full width and
depth in bf16 with phase 14's seeded weights, its first 8 seeded prompts
of 512–2,048 tokens (the same draws), ``BatchedServer`` at batch 8,
``--new-tokens`` greedy tokens (32, phase 14's); each decode step is
timed on the host with the device synchronised before and after
(``chip_smoke.timed``). Prints one JSON line: the card's name and power
limit, the decode ms of every step and their median, the prefill ms,
K-F's launches, and a SHA-256 of the tokens served, which is equal
across two checkouts exactly when they serve the same tokens. Imports
nothing of JAX."""
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
    ap.add_argument("--new-tokens", type=int, default=cs.LM_NEW)
    ap.add_argument("--out", default=None, help="append the line here too")
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("bench_decode: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, args.src)
    from repro_torch import configs
    from repro_torch.kernels import build, ops
    from repro_torch.models import ModelOptions, init_params
    from repro_torch.serve import BatchedServer, ServeConfig
    build.build()
    card = cs.card_line()
    cfg = configs.get_arch(cs.LM_ARCH)
    opts = ModelOptions(dtype=torch.bfloat16)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         opts, device="cuda")
    # phase 14's draws: the datastore's keys and values, then the prompts
    rng = np.random.default_rng(14)
    rng.standard_normal((cs.LM_STORE_KEYS, cs.LM_STORE_DIM),
                        dtype=np.float32)
    rng.integers(0, cfg.vocab, cs.LM_STORE_KEYS)
    prompts = [rng.integers(0, cfg.vocab, int(rng.integers(
        cs.LM_PROMPT[0], cs.LM_PROMPT[1] + 1))).astype(np.int32)
        for _ in range(cs.LM_REQUESTS)][:cs.LM_BATCH]
    prefill_ms, decode_ms = [], []
    srv = BatchedServer(cfg, ServeConfig(batch=cs.LM_BATCH), params, opts)
    srv.prefill_step = cs.timed(srv.prefill_step, prefill_ms)
    srv.decode_step = cs.timed(srv.decode_step, decode_ms)
    ops.reset_launch_counts()
    outs = srv.generate(prompts, max_new_tokens=args.new_tokens)
    launches = ops.launch_counts()["flash_attention"]
    h = hashlib.sha256()
    for o in outs:
        h.update(np.asarray(o, np.int64).tobytes())
    line = json.dumps(dict(
        card=card, src=args.src, arch=cfg.name, batch=cs.LM_BATCH,
        new_tokens=args.new_tokens, decode_ms=decode_ms,
        decode_ms_median=float(np.median(decode_ms)),
        prefill_ms=prefill_ms, kf_launches=launches,
        tokens_sha=h.hexdigest()[:16]))
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
