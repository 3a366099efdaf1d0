#!/usr/bin/env python3
"""Time the flash attention kernels (K-F forward, K-B backward) of one
checkout at the shapes of the port's paths, beside SDPA, on one NVIDIA
GPU.

    python3 tools/bench_attention.py [--src DIR] [--iters N] [--only TEXT]
                                     [--softcap CAP] [--entry kernel|model]
                                     [--out FILE]

``--src`` is the ``src`` directory of the checkout whose ``repro_torch``
is timed (default: this repository's); its kernels are built there, at
first use. To compare two versions, run this script over each checkout
in turns (A, B, B, A) on one card, one after another. Each shape prints
one JSON line: the card's name and power limit, the shape, K-F's (or
K-B's) mean CUDA-event ms over ``--iters`` launches after two warm-up
launches, its device time a call (the calls enqueued while the device
spins, ``chip_smoke.device_ms``), SDPA's device time a call for the same
function (``torch.nn.functional.scaled_dot_product_attention``; for K-B
``torch.autograd.grad`` of one SDPA output with a contiguous dO, the
graph kept), and a SHA-256 of the outputs' bytes, which is equal across
two versions exactly when their outputs are bit for bit equal. Inputs
are bf16, seeded per shape. ``--softcap`` passes a logit cap to K-F and
K-B (a checkout that has one; SDPA has none and is then timed
uncapped). ``--entry model`` times and checks K-F and K-B through the
entries the model calls (``kernels.ops.flash_attention``; K-B through
``kernels.flash_attention.flash_attention_bwd`` where the checkout has
it: the ``torch.library`` operators since they exist, the ``ctypes``
wrappers before) instead of the ``ctypes`` wrappers themselves
(``kernel``, the default). Shapes: K-F at llama3.2-3b's prefill (b 8, 2,048, GQA 24 / 8,
d 128; also with a 256-key window and at d = 192) and decode (2,080
keys of a cache), deepseek's MLA (absorbed decode and prefill at d =
576, MQA, v = k; expanded prefill at d = 192, v padded from 128), and
phase 20's families (whisper's encoder and cross-attention, non-causal;
recurrentgemma's windowed prefill and ring decode, MQA at d = 256;
qwen2-vl's prefill, GQA 28 / 4); K-B at phase 21's six train shapes.
The timers and the card line are ``chip_smoke.py``'s. Imports nothing
of JAX."""
from __future__ import annotations

import argparse
import hashlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402

# name, b, nq, nk, h, kvh, d, causal, window, d_v (v's used columns:
# MLA's expanded form pads v from 128), v_is_k (MLA's absorbed form)
KF_SHAPES = (
    ("llama prefill b=8 nq=nk=2048", 8, 2048, 2048, 24, 8, 128, True, None,
     None, False),
    ("llama prefill window 256", 8, 2048, 2048, 24, 8, 128, True, 256, None,
     False),
    ("llama decode b=8 nq=1 nk=2080", 8, 1, 2080, 24, 8, 128, True, None,
     None, False),
    ("prefill b=2 d=192", 2, 2048, 2048, 24, 8, 192, True, None, None,
     False),
    ("MLA absorbed decode b=8 nk=2064 d=576", 8, 1, 2064, 16, 1, 576, True,
     None, 512, True),
    ("MLA absorbed prefill b=8 nq=nk=2048 d=576", 8, 2048, 2048, 16, 1, 576,
     True, None, 512, True),
    ("MLA expanded prefill b=2 nq=nk=2048 d=192", 2, 2048, 2048, 16, 16,
     192, True, None, 128, False),
    ("whisper encoder b=8 1500x1500", 8, 1500, 1500, 12, 12, 64, False, None,
     None, False),
    ("whisper cross-attention b=8 224x1500", 8, 224, 1500, 12, 12, 64, False,
     None, None, False),
    ("whisper cross-attention b=8 1x1500", 8, 1, 1500, 12, 12, 64, False,
     None, None, False),
    ("recurrentgemma local prefill b=8 nq=nk=2048", 8, 2048, 2048, 16, 1,
     256, True, 2048, None, False),
    ("recurrentgemma ring decode b=8 nq=1 nk=2048", 8, 1, 2048, 16, 1, 256,
     False, None, None, False),
    ("qwen2-vl prefill b=8 nq=nk=2048", 8, 2048, 2048, 28, 4, 128, True,
     None, None, False),
)


def sha(*ts) -> str:
    """SHA-256 of the tensors' bytes (first 16 hex digits)."""
    import torch
    h = hashlib.sha256()
    for t in ts:
        h.update(t.contiguous().view(-1).view(torch.uint8).cpu().numpy()
                 .tobytes())
    return h.hexdigest()[:16]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--only", default=None,
                    help="time only the shapes whose name holds this")
    ap.add_argument("--softcap", type=float, default=0.0)
    ap.add_argument("--entry", choices=("kernel", "model"), default="kernel")
    ap.add_argument("--out", default=None, help="append the lines here too")
    args = ap.parse_args(argv)
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("bench_attention: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, args.src)
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import flash_attention as kf
    fwd, bwd = kf.flash_attention_cuda, kf.flash_attention_bwd_cuda
    if args.entry == "model":
        fwd = ops.flash_attention
        bwd = getattr(kf, "flash_attention_bwd", bwd)
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build()
    card = cs.card_line()
    dev = "cuda"
    cap = dict(softcap=args.softcap) if args.softcap else {}
    lines = []

    def emit(**row):
        line = json.dumps(dict(card=card, src=args.src, entry=args.entry,
                               **row))
        print(line, flush=True)
        lines.append(line)

    for i, (what, b, nq, nk, h, kvh, d, causal, window, d_v,
            v_is_k) in enumerate(KF_SHAPES):
        if args.only and args.only not in what:
            continue
        gen = torch.Generator(device=dev).manual_seed(100 + i)

        def rand(*shape):
            return torch.randn(shape, generator=gen, device=dev).to(
                torch.bfloat16)

        q, k = rand(b, nq, h, d), rand(b, nk + 64, kvh, d)[:, :nk]
        v = k if v_is_k else rand(b, nk, kvh, d)
        if d_v is not None and not v_is_k:
            v[..., d_v:] = 0
        kw = dict(causal=causal, window=window, **cap)
        out = fwd(q, k, v, **kw)
        torch.cuda.synchronize()
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        mask = None
        if window is not None:
            pos = torch.arange(nq, device=dev)[:, None] + (nk - nq)
            key = torch.arange(nk, device=dev)[None, :]
            mask = (key <= pos) & (key > pos - window)
        skw = dict(enable_gqa=True, attn_mask=mask,
                   is_causal=causal and mask is None and nq == nk and nq > 1,
                   scale=d ** -0.5)
        emit(kernel="K-F", shape=what, softcap=args.softcap,
             ms=cs.time_ms(lambda: fwd(q, k, v, **kw), iters=args.iters),
             device_ms=cs.device_ms(torch, lambda: fwd(q, k, v, **kw),
                                    iters=args.iters),
             sdpa_device_ms=cs.device_ms(
                 torch, lambda: F.scaled_dot_product_attention(
                     qt, kt, vt, **skw), iters=args.iters),
             plan=kf.last_plan._asdict(), sha=sha(out))
        del q, k, v, qt, kt, vt, out, mask
        torch.cuda.empty_cache()

    for i, (what, b, nq, nk, h, kvh, d, causal, window,
            d_v) in enumerate(cs.KB_SHAPES):
        if args.only and args.only not in what:
            continue
        gen = torch.Generator(device=dev).manual_seed(200 + i)

        def rand(*shape):
            return torch.randn(shape, generator=gen, device=dev).to(
                torch.bfloat16)

        q, k, v = rand(b, nq, h, d), rand(b, nk, kvh, d), rand(b, nk, kvh, d)
        do = rand(b, nq, h, d)
        if d_v is not None:
            v[..., d_v:] = 0
            do[..., d_v:] = 0
        kw = dict(causal=causal, window=window, **cap)
        out, lse = kf.flash_attention_cuda(q, k, v, return_lse=True, **kw)
        got = bwd(q, k, v, out, do, lse, **kw)
        torch.cuda.synchronize()
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        dot = do.transpose(1, 2).contiguous()
        mask = None
        if window is not None:
            pos = torch.arange(nq, device=dev)[:, None] + (nk - nq)
            key = torch.arange(nk, device=dev)[None, :]
            mask = (key <= pos) & (key > pos - window)
        ref = F.scaled_dot_product_attention(
            qt, kt, vt, enable_gqa=True, attn_mask=mask,
            is_causal=causal and mask is None and nq == nk)
        emit(kernel="K-B", shape=what, softcap=args.softcap,
             ms=cs.time_ms(lambda: bwd(q, k, v, out, do, lse, **kw),
                           iters=args.iters),
             device_ms=cs.device_ms(torch, lambda: bwd(
                 q, k, v, out, do, lse, **kw), iters=args.iters),
             sdpa_device_ms=cs.device_ms(torch, lambda: torch.autograd.grad(
                 ref, (qt, kt, vt), dot, retain_graph=True), iters=args.iters),
             plan=kf.last_bwd_plan._asdict(), sha=sha(*got))
        del q, k, v, do, out, lse, got, qt, kt, vt, dot, ref, mask
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "a") as f:
            f.write("".join(ln + "\n" for ln in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
