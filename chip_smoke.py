#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--out DIR]

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` (nvcc,
first use), holds each against its plain PyTorch version at the shapes
its path gives it, then drives the port's paths at the paper's data scale —
Forest CoverType's 581,012 rows × 10 attributes: the fused megastep
(``build_index`` → ``knn_join_batched(megastep=True)``), the int8
quantized tier (``build_index(quantize="int8")`` →
``knn_join_batched(quantized=True)``), both over all of R in 4096-query
batches, the paper's host-planned one-shot ``knn_join`` on a sample
of R, the mutable segmented index, and kNN-LM retrieval over a mutable
``Datastore`` — the LM serving path at full width (llama3.2-3b in
bf16 through ``BatchedServer`` with the kNN-LM hook; the MoE family's
deepseek-v2-lite-16b with MLA the same way), the paper's §6
comparison against its baselines (PBJ, H-BRJ) and the deadline-aware
serving scheduler under load, and checks each against a float64 brute
force and against each other. Phases:

1. card, versions, kernel build;
2. K-A (nearest pivot) vs its plain version, n = 581,012, M = 256, d = 10,
   with ``torch.cdist(x, pivots).min(dim=1)`` timed beside it, its form,
   split count, registers and spills, and its ids and distance bits held
   equal to its other form's and to K-D's at k = 1;
3. K-G (scheduled gather top-k) vs its plain version on one 4096-query
   bucket with the schedule the megastep's stage 3 made for it and ~1 %
   of the rows dead, with its split count;
4. the serving path, with both kernels' launch counters reset before it
   and read after it (each must be > 0);
5. the join against the float64 brute force on 2048 sampled queries;
   the share of queries whose K-G run the certificate could not prove
   and that re-ran exactly (ROADMAP C15; 0 expected on Forest);
6. one steady-state ``join_batch_device`` under
   ``torch.cuda.set_sync_debug_mode("error")``, then its step time, and
   the device's busy share (``torch.profiler``) of a steady-state step
   and of a 32-batch ``knn_join_batched``;
7. the port's quant tuning table's card cells (``tools/tune_quant.py``;
   every counted int8 path pins int8 with ``quant_slack``); K-Q (int8
   coarse scan) vs its plain version on one 4096-query
   bucket, with the schedule and θ the quant engine's stages 1–3 made
   for it and ~1 % of the rows dead: lb bit-equal, positions equal; its
   form and split count, and the share of the live pairs that passed
   the screen and reached the exact √ chain (a counter only this check
   launch passes);
8. the quantized path, counted (K-Q must launch; certification
   failures re-run through the host path's K-G), against the brute
   force and bitwise against phase 4's distances; one steady-state quant
   step under the sync debug mode, its time and profile, and the
   profile of a 32-batch quantized join;
9. the host-planned ``knn_join`` (pivots from R, gather reducer) on
   ``HOST_ROWS`` queries, counted (K-A and K-G must launch), and the
   pruned and dense reducers on smaller samples, each against the brute
   force and bitwise against the megastep on the same index;
10. K-D (dense top-k) vs its plain version: 4,096 centered queries over
   the 522,911 base rows (d = 10, k = 10), the same with a seeded 50 %
   visit mask, and 256 queries over 262,144 Gaussian keys of d = 1,024
   (k = 8), with ``torch.topk(torch.cdist(...))`` timed beside it and
   each launch's form (narrow or tile) and split count;
11. the mutable index: ``MutableIndex.build`` over the base rows, the
   other 58,101 rows inserted in waves of 4,096 (16 segments), then 48
   deletes (θ finite), 5,810 (θ = +inf) and ``compact``; in each stage
   the megastep join of all of R, counted (one K-G launch per batch),
   exact against the float64 brute force over the live rows and bitwise
   equal to a megastep over a fresh index of the survivors; in the
   first stage also the host route and the quantized route, bitwise
   equal to it, and a 16-segment step under the sync debug mode; in
   the second (whose deletes take the 80 nearest rows of 4 probe
   queries) the host route again, its over-fetch asking K-G for
   thousands of rows;
12. kNN-LM retrieval: a ``Datastore`` over the base rows, 16 decode
   steps of 4,096 queries through both ``knn_logits`` routes (K-D
   launched once a step) and through ``knn_logits(scheduler=
   ServeScheduler.for_datastore(store))``, with 1,024 entries added and
   16 removed between steps and a ``compact`` after step 8; each step's
   join route exact, the routes' distances and log-probabilities in
   agreement, the scheduler route's log-probabilities bitwise the join
   route's;
13. the shapes the kernels refused before: K-A at d = 3,072, K-G at d =
   256 / 1,024 (65,536 Gaussian rows) and at k = 100 / 1,024 (phase 3's
   bucket), K-D at k = 128 (phase 10 (a)), K-Q at d = 256 and mp =
   1,024 — each against its plain version, with K-D's and K-Q's forms
   and split counts — and K-G's widest register form (d = 128, k = 64,
   65,536 Gaussian rows);
14. the LM serving path: K-F (flash attention) vs its plain version at
   the prefill, windowed and decode shapes and at d = 192, with SDPA
   timed beside it and each shape's route and split count printed, and
   the tensor-core instructions in K-F's SASS counted (none fails);
   ``BatchedServer`` + ``make_knn_hook`` over a 1,048,576-key
   ``Datastore``, 16 requests of 512-2,048 tokens, batch 8, 32 greedy
   tokens, counted (K-F once per layer per forward, K-G every decode
   step, K-A in the build), every retrieval exact against float64,
   every layer's K-F output of one prefill and one decode step against
   the plain version; one more wave (8 requests, 8 greedy tokens) with
   ``make_knn_hook(scheduler=...)``, counted, its tokens equal to the
   direct hook's; the reduced model on the card and the CPU with
   the same weights (logits within 2e-5 + 2e-5·|logit|, tokens equal);
15. K-A at the other shapes the counted paths handed it (recorded as
   they ran: the LM datastore build, the host-planned R sample, the
   seals, the quantized fallback batches), as in phase 2;
16. the paper's §6 comparison at its settings (k = 10, 9 reducers, 128
   pivots): PGBJ (``knn_join``), PBJ and H-BRJ self-joins of 32,768
   Forest-like and 32,768 OSM-like rows, each counted (K-A and K-G
   launches per path), timed, with its selectivity, shuffle and α, and
   held bitwise against the float64 oracle (ids: near-ties); one L1 and
   one L∞ ``knn_join`` of the Forest rows against the L1 / L∞ oracle;
   ``python -m repro_torch.launch.join --n 581012 --expand 2 --verify``
   (Forest×2, 1,162,024 rows) in a subprocess;
17. serving under load: ``ServeScheduler`` in front of a quantized
   ``StreamJoinEngine`` over phase 8's index — ``dispatch`` (fp32 and
   quantized) under the sync debug mode; ``join_now`` bitwise
   ``join_batch`` with ``max_inflight`` 1 and 2; faults at
   ``sched.dispatch`` and ``megastep.fetch`` retried onto the host
   path with the same bits; open-loop bursty traffic of 16-row slices
   of R (a quarter bulk) on a ``VirtualClock`` with measured service
   times, ≥ 2,000 requests at 0.8× and 2× the saturation rate measured
   in the run, under the default ``SchedulerConfig`` and under
   ``batch_rows=4096``: every ``LoadReport`` field printed,
   ``n_expired_dispatched == 0``, exact tickets bitwise phase 4,
   degraded tickets' certified recall bounds at most their true recall
   against the float64 brute force. Each new phase prints its time;
18. the mesh, every shard simulated on the one card from an explicit
   device list: ``knn_join_batched(mesh=...)`` over all of R with 2, 4
   and 8 shards (K-G launched shards × batches times, bitwise phase 4,
   ids included on every slot),
   one steady-state sharded ``join_batch_device`` and ``dispatch`` under
   the sync debug mode; the sharded int8 tier on 4 shards (K-Q,
   bitwise phase 8's distances); a sharded ``Datastore`` over phase
   14's 1,048,576 × 32 keys (4 shards, r = 2: 16 retrieval steps
   bitwise a single-device store, a shard lost and failed over with the
   same bits, re-uploading masks only, ``recover_shards`` with the same
   bits; r = 1 with a shard lost: ``join_batch_covered`` and the
   scheduler's coverage rung, every certified recall bound at most the
   true recall); ``distributed_phase1`` on 8 shards (the bits of
   ``assign_and_summarize``, K-A 8 times); the shuffle join at the §6
   settings on 9 shards in L2 (K-D), L1 and L∞, each bitwise the
   float64 oracle; 32,768 OSM-like rows through the sharded and the
   single-device megastep, each bitwise the float64 oracle with the
   same ids (ROADMAP C15), their exact re-run share printed; the
   single-device megastep self-join of 581,012 OSM-like rows, its
   re-run share and the re-run's wall time, a 4,096-query sample
   bitwise the float64 oracle; and
   ``python -m repro_torch.launch.join --n 581012 --distributed
   --shards 4 --simulate --verify`` in a subprocess;
19. the MoE family: K-F vs its plain version at MLA's shapes (absorbed
   decode and prefill at d = 576, v = k; expanded prefill at d = 192, v
   padded) with SDPA beside each; deepseek-v2-lite-16b at full width
   and depth (27 layers, bf16) through ``BatchedServer`` +
   ``make_knn_hook`` over phase 14's keys, 8 requests of 512-2,048
   tokens, batch 8, 16 greedy tokens, counted (K-F 27 times a forward),
   every retrieval exact, every layer's K-F output of one prefill and
   one decode step against the plain version, the MoE's dropped share
   per layer; arctic-480b at full width cut to 2 layers (one prefill, 8
   decode steps, batch 4, counted, the layer check); the reduced
   deepseek and arctic on the card and on the CPU with the same
   weights (logits within 2e-5 + 2e-5·|logit|, tokens equal); K-F's
   read-only decode at the absorbed shape and deepseek's read-only cache
   (two prompts of 512 tokens, 16 teacher-forced steps with out-of-band
   appends) against the written decode, the cache's bytes unchanged;
20. the recurrent, hybrid, audio and VLM families: K-F vs its plain
   version at their shapes with SDPA beside each (whisper's encoder and
   cross-attention non-causal over 1,500 frames; recurrentgemma's
   windowed prefill and ring decode at d = 256, MQA; qwen2-vl's GQA 28 /
   4 prefill); recurrentgemma-9b, xlstm-350m and qwen2-vl-7b at full
   width and depth (bf16) through ``BatchedServer`` + ``make_knn_hook``
   over phase 14's keys, 8 requests of 512-2,048 tokens (the longest
   2,048, so recurrentgemma's decode wraps its ring), batch 8, 16 greedy
   tokens, counted (K-F once per attention layer a forward: 204 / 0 /
   476), every retrieval exact, the layer check past position 2,048;
   qwen2-vl once more with 64 seeded vision embeddings over (t, h, w)
   positions; whisper-small through ``encode`` (seeded stub frames, 8 ×
   1,500 × 768) and ``make_serve_step(enc_out=)``: 8 prompts of 16-224
   tokens, 32 greedy tokens (K-F 12 + 24 × 33), the layer check with
   the encoder's calls; each reduced config on the card and the CPU
   with the same weights (logits within 2e-5 + 2e-5·|logit|, tokens
   equal);
21. the train path: K-B (K-F's backward, ``csrc/flash_attn_bwd.cu``; bf16
   on the tensor cores, its SASS checked for them) vs
   its plain version on the same bf16 inputs and K-F lse at the train
   shapes of llama3.2-3b (b 4, T 1,024, GQA 24 / 8, d 128), recurrentgemma
   (MQA 16 / 1, d 256, window 2,048), whisper's encoder (1,500 × 1,500)
   and cross-attention (224 × 1,500) and deepseek's expanded MLA (d 192,
   v padded from 128): ‖Δ‖/‖ref‖ ≤ 2⁻⁸, dv's padded columns 0, a repeated
   launch the same bits, the plan's route (mma), tiles and row splits
   printed, with SDPA's backward and K-B's first, CUDA-core form's time
   beside it; K-F's
   output bitwise equal with and without lse at the dense and MLA
   shapes, lse against the plain version's; the reduced llama in float32
   card vs CPU (gradients, a train step, ``accum=4`` vs 1, AdamW and
   Adafactor on the same gradients) and a bitwise restart (4 steps
   against 2 + save / restore + 2); llama3.2-3b at full width and depth
   (28 layers, bf16, seeded) trained 8 steps through ``launch.train``
   (AdamW, remat, batch 4 × 1,024), counted (K-F 28 × 2 × 8, K-B 28 ×
   8), every loss and grad norm finite and falling, s/step, tokens/s and
   peak memory printed; one more such step profiled (the device's busy
   share, K-B's, K-F's and the matrix products' device time);
22. Queue A6e: K-F with the logit softcap (cap 50) in its tensor-core
   prefill (causal, windowed, non-causal) and split-KV decode forms and
   its read-only decode (a second key source) against the plain
   versions, K-B with the cap at phase 21's llama and recurrentgemma
   shapes; the capped reduced llama card vs CPU (logits, a read-only
   step, gradients); llama3.2-3b with cap 50 at full width and depth
   served (phase 14's first 8 prompts, 16 tokens, counted) and trained
   (4 steps, counted); llama3.2-3b's read-only cache (16 teacher-forced
   steps) against the written decode, the cache's bytes unchanged; the
   FSDP train step (``train.fsdp``) over 2 and 4 shards simulated on the
   card at full width cut to 8 layers against one device, and the
   2-shard state restarted onto 4.

Every time printed stands beside the card's name and power limit. The
line before the last two is one JSON object with each kernel's launches
(its main paths' plus phase 18's; K-F's main paths are phases 14 and
19-22, K-B's phases 21 and 22),
error, times and bound; the line before the last is the card's name and
power limit; the last is ``{"ok": true, "device": {...}}``. Any failure
exits non-zero before those lines, with its message on stdout and stderr
(also without a card, or where the script stands alone, away from the
repository's ``src/``). Long reports (nvcc's ``ptxas``
output, the profiles by kernel, phases 16–22's numbers as JSON) go
to ``--out`` (default ``build/chip_smoke/``). Needs one card, no network; imports nothing of
JAX.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
N_ROWS = 581_012          # UCI Covertype
N_BASE = 522_911          # the mutable index's and datastore's base (90 %)
DIM = 10
DEAD_A, DEAD_TOTAL = 48, N_ROWS // 100    # phase 11's stages A and B
LM_QUERIES, LM_KEYS, LM_DIM = 256, 262_144, 1024   # phase 10 (c)
DECODE_STEPS, ADD_ROWS, REMOVE_IDS = 16, 1024, 16  # phase 12
PROBES, PROBE_DEAD = 4, 80  # phase 11 stage B: the over-fetch probes
CAP_ROWS = 65_536           # phase 13: Gaussian rows of the wide shapes
PAPER_ROWS = 32_768         # phase 16: rows of each §6 self-join (cut
                            # from 65,536 to keep the phase near 90 s)
PAPER_K, PAPER_REDUCERS, PAPER_PIVOTS = 10, 9, 128   # _three_way's settings
EXPAND_ROWS = N_ROWS        # phase 16's Forest×2: Forest expanded twice
SERVE_ROWS, SERVE_REQUESTS = 16, 2000   # phase 17: rows a request, requests
SCHED_NEW = 8               # phase 14: tokens of the scheduler's wave
LM_ARCH = "llama3.2-3b"     # phase 14: the LM serving path at full width
LM_REQUESTS, LM_BATCH, LM_NEW = 16, 8, 32
LM_PROMPT = (512, 2048)     # prompt lengths, seeded
LM_STORE_KEYS, LM_STORE_DIM = 1_048_576, 32   # the kNN-LM datastore
BUCKET = 4096
C15_SAMPLE = 4096         # phase 18: OSM-like queries held to the oracle
HOST_ROWS = 65_536        # R sample of the host-planned gather path
PRUNED_ROWS = 512         # R samples of the pruned and dense reducers
DENSE_ROWS = 2048
DEV = "cuda"
H100_HBM_BYTES_S = 3.35e12    # H100 SXM data sheet
H100_FP32_FLOPS_S = 67e12     # fp32 on CUDA cores, no tensor cores
H100_INT8_OPS_S = 1979e12     # int8 tensor-core peak (dense)
H100_BF16_FLOPS_S = 989e12    # bf16 tensor-core peak (dense)


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


def cpu_line() -> str:
    """The host CPU's model name (``/proc/cpuinfo``), where Linux gives it."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return "CPU model not known"


def time_ms(fn, *, warmup: int = 2, iters: int = 10) -> float:
    """Mean device time of ``fn()`` over ``iters`` launches (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def timed(fn, into: list):
    """``fn`` wrapped to append each call's host wall ms, the device
    synchronised before and after, to ``into``."""
    import torch

    def run(*args, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        into.append((time.perf_counter() - t) * 1e3)
        return out
    return run


def to_device(tree):
    """A tree of dicts and lists of tensors, copied to ``DEV``."""
    from repro_torch.tree import tree_map
    return tree_map(lambda t: t.to(DEV), tree)


def record_retrievals(store, into: list):
    """Make ``store.retrieve`` append each call's (queries, distances,
    ids) to ``into``; returns the original method, to put back."""
    import numpy as np
    retrieve = store.retrieve

    def recording(queries, k=None, **kw):
        d, ids, values = retrieve(queries, k, **kw)
        into.append((np.array(queries), d, ids))
        return d, ids, values

    store.retrieve = recording
    return retrieve


def bound(n_bytes: float, flops: float,
          int8_ops: float = 0.0) -> tuple[float, str]:
    """The least time for the work: bytes over the HBM rate, or fp32
    operations and int8 operations over their peak rates, whichever is
    larger."""
    t_b = n_bytes / H100_HBM_BYTES_S * 1e3
    t_f = (flops / H100_FP32_FLOPS_S + int8_ops / H100_INT8_OPS_S) * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def pair_tol(a2, b2, d: int):
    """Limit on |d²_kernel − d²_plain| for a pair of rows with squared
    norms a2, b2 (float64 tensors). Each version sums the expanded form
    ‖a‖²+‖b‖²−2a·b in fp32 in its own order, off the exact d² by at most
    (2d+4)·u·(a2+b2) (u = 2⁻²⁴), and its √ output rounds d² by at most
    4u·(a2+b2) more; the limit is the sum of both versions' bounds."""
    return (a2 + b2) * (2 * (2 * d + 8)) * 2.0 ** -24


def check_runs(torch, what: str, q, s, d_k, p_k, d_p, p_p):
    """A kernel's top-k run against its plain version's on the same
    (queries ``q``, rows ``s``): empty slots equal, each slot's d² within
    its pair's limit (:func:`pair_tol`), and positions equal except at
    near-ties — each position's exact d² sits at its rank's order
    statistic within the limit, in both runs (the kernel's exact d² is
    off its own d² by half of the limit, and that off the plain
    version's by the limit). Returns ``(share of the limit used, share
    of equal positions, max |dist err|, the limits of the full slots)``.
    """
    full = p_p >= 0
    check(bool((full == (p_k >= 0)).all()),
          f"{what}: empty slots differ from the plain version")
    pk, pp = p_k.long().clamp(min=0), p_p.long().clamp(min=0)
    q64 = q.double()
    sk, sp = s[pk].double(), s[pp].double()              # (n, k, d)
    tol = pair_tol((q64 * q64).sum(1)[:, None],
                   torch.maximum((sk * sk).sum(-1), (sp * sp).sum(-1)),
                   q.shape[1])
    d2_k, d2_p = d_k.double() ** 2, d_p.double() ** 2
    used = float(torch.where(full, (d2_k - d2_p).abs() / tol, 0.0).max())
    check(used <= 1.0, f"{what}: run distances disagree with the plain "
          f"version")
    ex_k = ((q64[:, None, :] - sk) ** 2).sum(-1)
    ex_p = ((q64[:, None, :] - sp) ** 2).sum(-1)
    check(bool((((ex_k - d2_p).abs() <= 1.5 * tol)
                & ((ex_p - d2_p).abs() <= 0.5 * tol) | ~full).all()),
          f"{what}: positions differ beyond near-ties")
    same = float((p_k == p_p).double().mean())
    fin = torch.isfinite(d_p)
    err = float((d_k[fin] - d_p[fin]).abs().max()) if bool(fin.any()) \
        else 0.0
    return used, same, err, tol[full]


def tol_text(tol) -> str:
    return (f"limit median {float(tol.median()):.3e}, max "
            f"{float(tol.max()):.3e} in d²")


# K-A's launches on each counted path, as (n, m, d): the shapes the paths
# hand it, timed after the paths (``phase_assign_paths``)
ASSIGN_SHAPES: dict = {}
_PATH = [None]        # the counted path running, if any
ASSIGN_PTXAS: dict = {}  # K-A's kernels: (registers, spill bytes), from ptxas


def begin_path(ops, name: str) -> None:
    """Counters to 0 before a counted path; K-A's shapes go under ``name``."""
    ops.reset_launch_counts()
    _PATH[0] = name


def end_path(ops) -> dict:
    """The path's launch counts, read just after it."""
    _PATH[0] = None
    return ops.launch_counts()


def record_assign_shapes(ka) -> None:
    """Wrap K-A's launcher so that each launch on a counted path records its
    shape (the launch and its count are the wrapper's own)."""
    launch = ka.assign_cuda

    def recording(x, pivots, **kw):
        if _PATH[0] is not None:
            ASSIGN_SHAPES.setdefault(_PATH[0], []).append(
                (x.shape[0], pivots.shape[0], x.shape[1]))
        return launch(x, pivots, **kw)

    ka.assign_cuda = recording


def ptxas_usage(report: str) -> dict:
    """Registers and spill bytes of each kernel in a ``ptxas -v`` report,
    by a short name (``assign_narrow<10,4,3>``, ``assign_tile``)."""
    import re
    out, name = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"(assign_(?:narrow|tile|fold))(I(?:Li\d+E)+E)?",
                          m.group(1))
            args = [] if k is None or k.group(2) is None else \
                re.findall(r"Li(\d+)E", k.group(2))
            name = None if k is None else k.group(1) + (
                f"<{','.join(args)}>" if args else "")
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            out[name] = [None, int(m.group(1)) + int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m and name in out:
            out[name][0] = int(m.group(1))
    return out


def device_ms(torch, fn, iters: int = 10) -> float:
    """Device time a call of ``fn``: CUDA events around ``iters`` calls
    that the host enqueues while the device spins (``torch.cuda._sleep``),
    so that at a small shape the events time the device, not the host's
    enqueue of each call. Where the spin ended before the host had
    enqueued every call, it is made 4x longer and the calls timed again
    (three times at most)."""
    fn()
    torch.cuda.synchronize()
    cycles = 10_000_000                # ~5 ms at the card's clock
    for _ in range(4):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        ahead = not start.query()      # every call enqueued within the spin
        torch.cuda.synchronize()
        if ahead:
            break
        cycles *= 4
    return start.elapsed_time(end) / iters


def assign_instance(ka, plan, d: int) -> str:
    """The kernel instance a K-A plan launches (``ASSIGN_PTXAS``'s key)."""
    if plan.form == "tile":
        return "assign_tile"
    width = next(w for w in ka._NARROW_WIDTHS if d <= w)
    return f"assign_narrow<{width},{plan.rows // 32},"


def phase_assign(card, torch, rt, s_dev, pivots, *, plain_iters: int = 5):
    """K-A vs its plain version at one shape: ids equal but at near-ties,
    d² within each pair's limit; bitwise equal in its other form (d <= 32)
    and to K-D at k = 1 (the same chains); its form, split count,
    registers and spills; kernel, device, plain and cdist + min times."""
    from repro_torch.kernels import assign as ka
    from repro_torch.kernels import distance_topk as kd
    n, d = s_dev.shape
    m = pivots.shape[0]
    pid_k, dist_k = ka.assign_cuda(s_dev, pivots)
    plan = ka.last_assign_plan
    bits = dist_k.view(torch.int32)
    others = ["tile"] if plan.form == "narrow" else []
    for form in others:
        pid_f, dist_f = ka.assign_cuda(s_dev, pivots, form=form)
        check(torch.equal(pid_f, pid_k)
              and torch.equal(dist_f.view(torch.int32), bits),
              f"K-A: the {form} form differs from the {plan.form} form")
    dk, ik = kd.distance_topk_cuda(s_dev, pivots, 1)
    check(torch.equal(ik[:, 0], pid_k)
          and torch.equal(dk[:, 0].view(torch.int32), bits),
          "K-A: ids or distance bits differ from K-D at k = 1")
    del dk, ik
    pid_p, dist_p = ka.assign_plain(s_dev, pivots)
    torch.cuda.synchronize()
    x64 = s_dev.double()
    p64 = pivots.double()
    p2 = (p64 * p64).sum(1)
    tol = pair_tol((x64 * x64).sum(1), torch.maximum(p2[pid_k.long()],
                                                     p2[pid_p.long()]), d)
    d2_k, d2_p = dist_k.double() ** 2, dist_p.double() ** 2
    used = float(((d2_k - d2_p).abs() / tol).max())
    check(used <= 1.0,
          "K-A: distances disagree with the plain version beyond tolerance")
    diff = pid_k != pid_p
    n_diff = int(diff.sum())
    if n_diff:
        # near-ties only: both picks' exact d² within the tolerance
        rows = diff.nonzero()[:, 0]
        ex_k = ((x64[rows] - p64[pid_k[rows].long()]) ** 2).sum(1)
        ex_p = ((x64[rows] - p64[pid_p[rows].long()]) ** 2).sum(1)
        check(bool(((ex_k - ex_p).abs() <= tol[rows]).all()),
              f"K-A: {n_diff} pivot ids differ beyond near-ties")
    err = float((dist_k - dist_p).abs().max())
    ms = time_ms(lambda: ka.assign_cuda(s_dev, pivots), iters=20)
    dev_ms = device_ms(torch, lambda: ka.assign_cuda(s_dev, pivots))
    plain_ms = time_ms(lambda: ka.assign_plain(s_dev, pivots),
                       warmup=1, iters=plain_iters)
    # the yardstick: two library calls for the same function, never
    # called by the port
    lib_ms = time_ms(lambda: torch.cdist(s_dev, pivots).min(dim=1), iters=5)
    b_ms, b_by = bound(4.0 * (n * d + m * d + 2 * n),
                       float(n) * m * (2 * d + 3))
    regs, spill = ASSIGN_PTXAS.get(next(
        (k for k in ASSIGN_PTXAS if k.startswith(assign_instance(ka, plan, d))),
        None), (None, None))
    print(f"[{card}] K-A assign n={n} m={m} d={d}, {plan.form} form, "
          f"{plan.splits} splits of {plan.per} pivots ({regs} registers, "
          f"{spill} bytes spilled): bitwise equal to "
          + "".join(f"the {f} form and " for f in others)
          + f"K-D at k = 1; ids differ from the plain version at {n_diff} "
          f"near-tie rows, max |dist err| {err:.3e}, max |d² err| "
          f"{used:.3e} of its pair's tolerance ({tol_text(tol)}); kernel "
          f"{ms:.4f} ms (device {dev_ms:.4f} ms), plain {plain_ms:.4f} ms, "
          f"cdist+min (two library calls) "
          f"{lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})", flush=True)
    return dict(name="assign", route="cuda",
                source="src/repro_torch/csrc/assign.cu",
                replaces="src/repro/kernels/assign.py:23",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms, device_ms=dev_ms,
                form=plan.form, splits=plan.splits, registers=regs,
                spill_bytes=spill)


def phase_assign_paths(card, torch, rt) -> list:
    """K-A at the shapes the counted paths handed it, other than the
    Forest build's (phase 2): per path and pivot table, each distinct row
    count of a launch, or the most and the median — the LM datastore
    build, the host-planned R sample, the seals, the quantized tier's
    fallback batches — on seeded Gaussian rows (K-A's work does not
    depend on the data), each held against its plain version as in
    phase 2."""
    gen = torch.Generator(device=DEV).manual_seed(18)
    done, cases = {(N_ROWS, 256, DIM)}, []
    for path, shapes in ASSIGN_SHAPES.items():
        by_table = {}
        for n, m, d in shapes:
            by_table.setdefault((m, d), []).append(n)
        for (m, d), ns in sorted(by_table.items()):
            # each distinct row count, or the most and the median launch's
            ns = sorted(ns)
            picks = set(ns) if len(set(ns)) <= 3 else {ns[-1], ns[len(ns) // 2]}
            for n in sorted(picks, reverse=True):
                if (n, m, d) in done:
                    continue
                done.add((n, m, d))
                x = torch.randn((n, d), generator=gen, device=DEV)
                piv = torch.randn((m, d), generator=gen, device=DEV)
                row = phase_assign(card, torch, rt, x, piv, plain_iters=2)
                cases.append(dict(
                    shape=f"{path}: n = {n} (of {len(ns)} launches with "
                          f"{m} pivots of d = {d}, n {min(ns)}-{max(ns)})",
                    n=n, m=m, d=d, launches=len(ns),
                    **{k: row[k] for k in _ROW_KEYS + (
                        "device_ms", "form", "splits")}))
                del x, piv
    torch.cuda.empty_cache()
    return cases


def gather_inputs(torch, rt, s_np, r_np, cfg):
    """K-G's inputs on one bucket at the megastep's shapes: the centered
    queries and rows, the schedule and counts stage 3 made for them, and
    an alive mask with ~1 % of the rows dead."""
    import numpy as np
    from repro_torch.core.megastep import assign_bounds_schedule
    idx = rt.build_index(s_np, cfg, device=DEV)
    eng = rt.MegastepEngine(idx, cfg, device=DEV)
    pl = eng.payload()
    q, n_valid = eng.enqueue(r_np[:BUCKET])
    _, qcs, _, _, sched, cnt = assign_bounds_schedule(q, n_valid, pl,
                                                      k=cfg.k, bm=cfg.tile_r)
    rng = np.random.default_rng(7)
    alive = pl.alive.clone()
    dead = torch.as_tensor(rng.choice(idx.n_s, idx.n_s // 100,
                                      replace=False), device=DEV)
    alive[dead] = 0.0
    return dict(qcs=qcs, s_c=pl.s_c, sched=sched, cnt=cnt, alive=alive,
                bm=cfg.tile_r, bn=cfg.tile_s)


def gather_case(card, torch, what: str, g: dict, k: int, *,
                plain_iters: int = 3) -> dict:
    """K-G vs its plain version on ``gather_inputs`` asking for ``k``:
    the run checks of :func:`check_runs`, no dead row in a run, times
    and the bound of these inputs' work."""
    from repro_torch.kernels import distance_topk as kg
    qcs, s_c, sched, cnt, alive = (g["qcs"], g["s_c"], g["sched"], g["cnt"],
                                   g["alive"])
    bm, bn = g["bm"], g["bn"]
    args = (qcs, s_c, k, sched, cnt)
    kw = dict(alive=alive, bm=bm, bn=bn)
    d_k, p_k = kg.distance_topk_gather_cuda(*args, **kw)
    plan = kg.last_plan
    d_p, p_p = kg.distance_topk_gather_plain(*args, **kw)
    torch.cuda.synchronize()
    full = p_p >= 0
    check(not bool(((alive[p_k.long().clamp(min=0)] <= 0) & full).any()),
          f"K-G ({what}): a dead row entered the kernel's runs")
    used, same, err, tol = check_runs(torch, f"K-G ({what})", qcs, s_c, d_k,
                                      p_k, d_p, p_p)
    del d_k, p_k, d_p, p_p
    ms = time_ms(lambda: kg.distance_topk_gather_cuda(*args, **kw), iters=20)
    plain_ms = time_ms(lambda: kg.distance_topk_gather_plain(*args, **kw),
                       warmup=1, iters=plain_iters)
    nr_tiles, ns_tiles = sched.shape[0], s_c.shape[0] // bn
    counts = cnt.long()
    slot = torch.arange(sched.shape[1], device=DEV)[None, :]
    visited = sched.long()[slot < counts[:, None]]       # (Σ cnt,) tiles
    live_per_tile = (alive.reshape(ns_tiles, bn) > 0).sum(1)
    pairs = float(bm * live_per_tile[visited].sum())
    tiles = torch.unique(visited)
    d = qcs.shape[1]
    n_bytes = (4.0 * qcs.numel() + tiles.numel() * bn * (4.0 * d + 4.0)
               + 4.0 * (int(counts.sum()) + nr_tiles) + 8.0 * qcs.shape[0] * k)
    b_ms, b_by = bound(n_bytes, pairs * (2 * d + 3))
    frac = float(counts.sum()) / (nr_tiles * ns_tiles)
    print(f"[{card}] K-G gather top-k ({what}) bucket={qcs.shape[0]} d={d} "
          f"k={k} bm={bm} bn={bn}, {plan.splits} splits of {plan.per} "
          f"schedule slots, {plan.warps} warps of {plan.qw} queries a block: "
          f"visited-tile "
          f"fraction {frac:.4f}, "
          f"positions equal {same:.6f} (rest near-ties), max |dist err| "
          f"{err:.3e}, max |d² err| {used:.3e} of its pair's tolerance "
          f"({tol_text(tol)}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"bound {b_ms:.4f} ms ({b_by})", flush=True)
    return dict(shape=what, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=None,
                splits=plan.splits)


def phase_gather(card, torch, rt, s_np, r_np, cfg):
    """K-G vs its plain version on one bucket at the megastep's shapes."""
    from repro_torch.kernels.sorted_merge import next_pow2
    g = gather_inputs(torch, rt, s_np, r_np, cfg)
    row = dict(name="distance_topk_gather", route="cuda",
               source="src/repro_torch/csrc/gather_topk.cu",
               replaces="src/repro/kernels/distance_topk.py:189")
    case = gather_case(card, torch, "Forest bucket", g, next_pow2(cfg.k))
    row.update({key: case[key] for key in ("max_abs_err", "ms", "plain_ms",
                                           "bound_ms", "bound_by",
                                           "library_ms")})
    return row, g


def phase_quant(card, torch, rt, idx, r_np, cfg, *, plain_iters: int = 3):
    """K-Q vs its plain version on one bucket at the quant path's shapes:
    the schedule and θ its stages 1–3 made, ~1 % of the rows dead."""
    import numpy as np
    from repro_torch.core.bounds import pad_theta
    from repro_torch.core.megastep import assign_bounds_schedule
    from repro_torch.kernels import quant_topk as kq
    from repro_torch.quant.engine import quantize_queries

    eng = rt.QuantMegastepEngine(idx, cfg, device=DEV)
    pl = eng.payload()
    q, n_valid = eng.enqueue(r_np[:BUCKET])
    bm, bn, mp = cfg.tile_r, cfg.tile_s, eng.mp
    qs, _, _, th_q, sched, cnt = assign_bounds_schedule(q, n_valid, pl,
                                                        k=cfg.k, bm=bm)
    qi, qsc, qe = quantize_queries(qs)
    rng = np.random.default_rng(8)
    alive = pl.alive.clone()
    dead = torch.as_tensor(rng.choice(idx.n_s, idx.n_s // 100,
                                      replace=False), device=DEV)
    alive[dead] = 0.0
    args = (qi, qsc, qe, pad_theta(th_q).contiguous(), pl.sq, pl.sscale,
            pl.seps, alive, mp, sched, cnt)
    # the check launch counts the live pairs screened and the pairs that
    # reached the exact √ chain (the main path passes no counter)
    screen = torch.zeros(2, dtype=torch.int64, device=DEV)
    lb_k, p_k = kq.quant_coarse_gather_cuda(*args, bm=bm, bn=bn,
                                            stats=screen)
    plan = kq.last_plan
    lb_p, p_p = kq.quant_coarse_sched_plain(*args, bm=bm, bn=bn)
    torch.cuda.synchronize()
    check(torch.equal(lb_k.view(torch.int32), lb_p.view(torch.int32)),
          "K-Q: lb not bit-equal to the plain version")
    # positions: equal, except where lb ties at the run's last slot
    diff = p_k != p_p
    tail_tie = lb_k == lb_k[:, -1:]
    check(not bool((diff & ~tail_tie).any()),
          "K-Q: positions differ from the plain version")
    full = p_k >= 0
    check(not bool(((alive[p_k.long().clamp(min=0)] <= 0) & full).any()),
          "K-Q: a dead row entered the shortlist")
    fin = torch.isfinite(lb_k)
    err = float((lb_k[fin] - lb_p[fin]).abs().max()) if bool(
        fin.any()) else 0.0
    ms = time_ms(lambda: kq.quant_coarse_gather_cuda(*args, bm=bm, bn=bn),
                 iters=20)
    plain_ms = time_ms(lambda: kq.quant_coarse_sched_plain(*args, bm=bm,
                                                           bn=bn),
                       warmup=1, iters=plain_iters)
    # work of these inputs: each live row of each visited tile against
    # the R tile's bm queries; each visited tile read once
    nr_tiles, ns_tiles = sched.shape[0], pl.sq.shape[0] // bn
    counts = cnt.long()
    slot = torch.arange(sched.shape[1], device=DEV)[None, :]
    visited = sched.long()[slot < counts[:, None]]
    live_per_tile = (alive.reshape(ns_tiles, bn) > 0).sum(1)
    pairs = float(bm * live_per_tile[visited].sum())
    tiles = torch.unique(visited)
    d = qi.shape[1]
    n_bytes = (qi.numel() + 12.0 * qi.shape[0]
               + tiles.numel() * (bn * (d + 2.0 + 4.0) + 4.0)
               + 4.0 * (int(counts.sum()) + nr_tiles)
               + 8.0 * qi.shape[0] * mp)
    int8_ops, f32_ops = pairs * 2 * d, pairs * 16
    b_ms, b_by = bound(n_bytes, f32_ops, int8_ops)
    frac = float(counts.sum()) / (nr_tiles * ns_tiles)
    n_live, n_chain = (int(x) for x in screen.tolist())
    check(0 < n_live and 0 <= n_chain <= n_live,
          f"K-Q: screen counters out of range ({n_live}, {n_chain})")
    form = (f"{plan.qb} queries a block ({plan.qpw} a warp), "
            f"{'wide' if plan.wide else 'shared-memory'} runs, chunks of "
            f"{plan.chunk} rows, {plan.splits} splits of {plan.per} "
            f"schedule slots")
    print(f"[{card}] K-Q int8 coarse scan bucket={qi.shape[0]} d={d} mp={mp} "
          f"bm={bm} bn={bn}, {form}: visited-tile fraction {frac:.4f}, "
          f"pairs that reached the exact chain {n_chain} of {n_live} live "
          f"pairs screened ({n_chain / n_live:.4%}), lb "
          f"bit-equal to the plain version, positions equal "
          f"{float((~diff).double().mean()):.6f} (rest ties at the run's "
          f"tail), kept slots {float(full.double().mean()):.4f}; kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms "
          f"({b_by}: {n_bytes:.4e} bytes, {int8_ops:.4e} int8 + "
          f"{f32_ops:.4e} fp32 operations = {pairs:.4e} pairs x (2d int8 "
          f"+ 16 fp32))", flush=True)
    return dict(name="quant_coarse_gather", route="cuda",
                source="src/repro_torch/csrc/quant_coarse.cu",
                replaces="src/repro/kernels/quant_topk.py:105",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None, form=form,
                splits=plan.splits, chain_share=n_chain / n_live)


def check_exact(card, rt, what: str, r_np, s_np, d, i, k: int, *,
                n_sample: int = 2048, report: bool = True) -> None:
    """A join result against the float64 brute force on ``n_sample``
    sampled queries (all of them when fewer), tie-aware: distances
    within 4 ulp (equal bits expected: both report the canonical chain),
    every reported id's true distance within the true k-th, no
    duplicate ids."""
    import numpy as np
    check(d.shape == (r_np.shape[0], k) and bool(np.isfinite(d).all())
          and bool((i >= 0).all()), f"{what}: malformed result")
    n = r_np.shape[0]
    sample = np.random.default_rng(3).choice(n, min(n_sample, n),
                                             replace=False)
    bd, bi = rt.brute_force_knn(r_np[sample], s_np, k, device=DEV)
    got_d, got_i = d[sample], i[sample]
    ulp = np.spacing(np.maximum(bd, 1.0).astype(np.float32))
    check(bool((np.abs(got_d - bd) <= 4 * ulp).all()),
          f"{what}: reported distances off the brute force beyond 4 ulp")
    q64 = r_np[sample].astype(np.float64)
    s64 = s_np.astype(np.float64)
    true_d = np.sqrt(((q64[:, None, :] - s64[got_i]) ** 2).sum(-1))
    kth = np.sqrt(((q64[:, None, :] - s64[bi[:, -1:]]) ** 2).sum(-1))
    check(bool((true_d <= kth * (1 + 1e-6) + 1e-6).all()),
          f"{what}: a reported id lies beyond the true k-th distance")
    check(all(len(set(row)) == k for row in got_i.tolist()),
          f"{what}: duplicate ids in a row")
    if report:
        print(f"[{card}] {what} vs brute force (fp64) on {len(sample)} "
              f"queries: max |dist diff| "
              f"{float(np.abs(got_d - bd).max()):.3e}, ids equal "
              f"{float((got_i == bi).mean()):.6f} (rest exact ties)",
              flush=True)


def live_positions(what: str, gids, ids):
    """Global ids → positions in the ascending live-id table ``gids``;
    fails if an id is not live (dead, or never allocated)."""
    import numpy as np
    pos = np.clip(np.searchsorted(gids, ids), 0, gids.shape[0] - 1)
    check(bool((gids[pos] == ids).all()), f"{what}: an id is not live")
    return pos


def check_exact_live(card, rt, what: str, r_np, mi, d, i, k: int,
                     **kw):
    """:func:`check_exact` against the live rows of a ``MutableIndex``
    (global ids mapped to live-row positions). Returns (rows, gids)."""
    rows, gids = mi.live_rows()
    check_exact(card, rt, what, r_np, rows, d,
                live_positions(what, gids, i), k, **kw)
    return rows, gids


def check_same_distances(what: str, d, ref_d, i, ref_i, q, s, *,
                         gids=None) -> None:
    """Two routes' canonical distances bit for bit; ids may differ only
    among exactly tied rows: at every slot where they differ, both ids
    name rows of ``s`` whose float64 distances to the slot's query (row
    of ``q``) are equal, and the route's row holds no id twice. ``gids``
    (ascending) maps global ids to rows of ``s`` (a mutable index's live
    rows)."""
    import numpy as np
    check(np.array_equal(d, ref_d),
          f"{what}: distances not bitwise the reference route's")
    rows, cols = np.nonzero(i != ref_i)
    if not rows.size:
        return
    a, b = i[rows, cols], ref_i[rows, cols]
    if gids is not None:
        a, b = live_positions(what, gids, a), live_positions(what, gids, b)
    n_s = s.shape[0]
    check(bool(((a >= 0) & (a < n_s) & (b >= 0) & (b < n_s)).all()),
          f"{what}: an id out of range")
    q64 = np.asarray(q, np.float64)[rows]
    s_a = np.asarray(s[a], np.float64)
    s_b = np.asarray(s[b], np.float64)
    d_a = ((s_a - q64) ** 2).sum(1)
    d_b = ((s_b - q64) ** 2).sum(1)
    off = int((d_a != d_b).sum())
    check(off == 0, f"{what}: {off} of the {rows.size} slots whose ids "
                    f"differ are not exact float64 ties")
    k = i.shape[1]
    check(all(len(set(i[r].tolist())) == k for r in np.unique(rows)),
          f"{what}: duplicate ids in a row")


def dense_case(card, torch, kd, what: str, q, s, k: int, mask, *,
               library: bool, bm: int = 128, bn: int = 512) -> dict:
    """K-D against its plain version on one shape; times both, and one
    ``torch.topk(torch.cdist(q, s))`` (two library calls, never used by
    the port) where no mask applies."""
    kw = dict(visit_mask=mask, bm=bm, bn=bn)
    d_k, p_k = kd.distance_topk_cuda(q, s, k, **kw)
    plan = kd.last_dense_plan
    d_p, p_p = kd.distance_topk_plain(q, s, k, **kw)
    torch.cuda.synchronize()
    used, same, err, tol = check_runs(torch, f"K-D ({what})", q, s, d_k,
                                      p_k, d_p, p_p)
    ms = time_ms(lambda: kd.distance_topk_cuda(q, s, k, **kw), iters=10)
    plain_ms = time_ms(lambda: kd.distance_topk_plain(q, s, k, **kw),
                       warmup=1, iters=2)
    lib_ms = (time_ms(lambda: torch.topk(torch.cdist(q, s), k,
                                         largest=False),
                      warmup=1, iters=3) if library else None)
    # the work of these inputs: each (query, row) pair of a visited
    # (R tile, S tile); each input read once, each output written once
    n_r, d = q.shape
    n_s = s.shape[0]
    q_per = torch.full((-(-n_r // bm),), bm, dtype=torch.float64,
                       device=DEV)
    q_per[-1] = n_r - bm * (q_per.shape[0] - 1)
    s_per = torch.full((-(-n_s // bn),), bn, dtype=torch.float64,
                       device=DEV)
    s_per[-1] = n_s - bn * (s_per.shape[0] - 1)
    vis = (torch.ones((q_per.shape[0], s_per.shape[0]), dtype=torch.float64,
                      device=DEV) if mask is None else (mask != 0).double())
    pairs = float(q_per @ vis @ s_per)
    rows_read = float(s_per[vis.amax(0) > 0].sum())
    n_bytes = (4.0 * d * (n_r + rows_read) + 8.0 * n_r * k
               + (0 if mask is None else mask.numel()))
    b_ms, b_by = bound(n_bytes, pairs * (2 * d + 3))
    print(f"[{card}] K-D dense top-k ({what}) n_r={n_r} n_s={n_s} d={d} "
          f"k={k}, {plan.form} form, {plan.splits} splits of {plan.per} S "
          f"tiles" + ("" if mask is None else
                      f", visited-tile fraction {float(vis.mean()):.4f}")
          + f": ids equal {same:.6f} (rest near-ties), max |dist err| "
          f"{err:.3e}, max |d² err| {used:.3e} of its pair's tolerance "
          f"({tol_text(tol)}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"cdist+topk (two library calls) "
          + ("none (masked)" if lib_ms is None else f"{lib_ms:.4f} ms")
          + f", bound {b_ms:.4f} ms ({b_by}: {pairs:.4e} pairs x (2d+3) "
          f"fp32 operations, {n_bytes:.4e} bytes)", flush=True)
    return dict(shape=what, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                form=plan.form, splits=plan.splits)


def phase_dense(card, torch, rt, s_np, r_np) -> dict:
    """K-D vs its plain version: (a) the retrieval shape — 4,096
    queries over the 522,911 base rows, centered, d = 10, k = 10; (b)
    the same with a seeded 50 % visit mask; (c) a kNN-LM width — 256
    queries over 262,144 Gaussian keys of d = 1,024 (1 GiB), k = 8."""
    import numpy as np
    from repro_torch.kernels import distance_topk as kd
    base = torch.as_tensor(s_np[:N_BASE], device=DEV)
    center = base.double().mean(0).float()
    s_c = (base - center).contiguous()
    q_c = (torch.as_tensor(r_np[:BUCKET], device=DEV) - center).contiguous()
    a = dense_case(card, torch, kd, "a: retrieval shape", q_c, s_c, 10,
                   None, library=True)
    rng = np.random.default_rng(10)
    mask = torch.as_tensor(
        (rng.random((BUCKET // 128, -(-N_BASE // 512))) < 0.5)
        .astype(np.int8), device=DEV)
    b = dense_case(card, torch, kd, "b: 50 % visit mask", q_c, s_c, 10,
                   mask, library=False)
    del base, s_c
    g = torch.Generator(device=DEV).manual_seed(4)
    keys = torch.randn((LM_KEYS, LM_DIM), generator=g, device=DEV)
    qw = torch.randn((LM_QUERIES, LM_DIM), generator=g, device=DEV)
    c = dense_case(card, torch, kd, "c: kNN-LM width", qw, keys, 8, None,
                   library=True)
    del keys
    torch.cuda.empty_cache()
    row = dict(name="distance_topk", route="cuda",
               source="src/repro_torch/csrc/dense_topk.cu",
               replaces="src/repro/kernels/distance_topk.py:71")
    row.update({key: a[key] for key in ("max_abs_err", "ms", "plain_ms",
                                        "bound_ms", "bound_by",
                                        "library_ms", "form", "splits")})
    row["other_shapes"] = [b, c]
    return row


def phase_mutable(card, torch, rt, s_np, r_np, cfg, launches,
                  out_dir: Path) -> None:
    """The mutable index at Forest scale: a base of 522,911 rows, the
    other 58,101 inserted in waves of 4,096 (14 sealed deltas and 757
    buffered rows: 16 segments), then stage A (48 seeded deletes, θ
    finite), stage B (5,810 in all, 1 %: θ = +inf) and stage C
    (``compact``). Each stage: the megastep join of all of R, exact
    against the float64 brute force over the live rows, bitwise equal
    to a megastep over a fresh ``build_index`` of the survivors, one
    K-G launch per batch; in stage A also the host route and the
    quantized route on ``HOST_ROWS`` queries, and one multi-segment
    ``join_batch_device`` under the sync debug mode."""
    import numpy as np
    from repro_torch.kernels import ops
    refreshes = rt.obs.metrics.REGISTRY.counter(
        "megastep_payload_refresh_total")

    def synced(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    mi, t_build = synced(lambda: rt.MutableIndex.build(
        s_np[:N_BASE], cfg, seal_threshold=BUCKET, device=DEV))
    eng = rt.MegastepEngine(mi, cfg, device=DEV)
    qd, nv = eng.enqueue(r_np[:BUCKET])
    steps = {"1 segment, 0 tombstones":
             time_ms(lambda: eng.join_batch_device(qd, nv), iters=10)}
    held = s_np[N_BASE:]
    _, t_insert = synced(lambda: [mi.insert(held[lo:lo + BUCKET])
                                  for lo in range(0, held.shape[0], BUCKET)])
    n_sealed, n_buf = divmod(held.shape[0], BUCKET)
    n_segs = 1 + n_sealed + (n_buf > 0)
    check(len(mi.segments) == 1 + n_sealed and mi.n_buffered == n_buf
          and mi.n_segments == n_segs,
          f"mutable index: expected {n_sealed} sealed deltas + {n_buf} "
          f"buffered rows, got {mi!r}")
    _, t_ref_struct = synced(eng.payload)
    steps[f"{n_segs} segments, 0 tombstones"] = time_ms(
        lambda: eng.join_batch_device(qd, nv), iters=10)
    print(f"[{card}] mutable index: build {t_build:.3f} s over {N_BASE} "
          f"rows; {held.shape[0]} rows inserted in {t_insert:.3f} s "
          f"({len(mi.segments) - 1} seals, {mi.n_buffered} buffered); "
          f"payload refresh after the inserts {t_ref_struct * 1e3:.3f} ms",
          flush=True)

    rng = np.random.default_rng(11)
    dead_a = rng.choice(N_ROWS, DEAD_A, replace=False)
    # stage B takes the PROBE_DEAD nearest rows of the first PROBES
    # queries with it, so the host route must re-fetch their segment at
    # k + (its tombstones) rows: over-fetch far past 64 in K-G
    _, near = rt.brute_force_knn(r_np[:PROBES], s_np, PROBE_DEAD, device=DEV)
    probe_ids = np.setdiff1d(np.unique(near), dead_a)
    dead_b = np.concatenate([probe_ids, rng.choice(
        np.setdiff1d(np.arange(N_ROWS), np.union1d(dead_a, probe_ids)),
        DEAD_TOTAL - DEAD_A - probe_ids.size, replace=False)])
    stages = (("A", lambda: mi.delete(dead_a), n_segs, DEAD_A),
              ("B", lambda: mi.delete(dead_b), n_segs, DEAD_TOTAL),
              ("C", mi.compact, 1, 0))
    for name, mutate, n_segs, n_dead in stages:
        _, t_mut = synced(mutate)
        before = refreshes.value
        _, t_refresh = synced(eng.payload)
        n_rebuilt = refreshes.value - before
        key = (f"{n_segs} segment{'s' * (n_segs > 1)}, {n_dead} tombstones"
               + (", compacted" if name == "C" else ""))
        steps[key] = time_ms(lambda: eng.join_batch_device(qd, nv), iters=10)
        begin_path(ops, f"mutable_{name}")
        res, t_join = synced(lambda: rt.knn_join_batched(
            r_np, index=mi, batch_size=BUCKET, megastep=True, device=DEV))
        counts = launches[f"mutable_{name}"] = end_path(ops)
        st = res.stats
        check(st.n_segments == n_segs and st.n_tombstones == n_dead
              and mi.n_tombstones == n_dead,
              f"stage {name}: {st.n_segments} segments / {st.n_tombstones} "
              f"tombstones, expected {n_segs} / {n_dead}")
        check(counts["distance_topk_gather"] == st.n_batches,
              f"stage {name}: K-G launched {counts['distance_topk_gather']} "
              f"times for {st.n_batches} batches")
        rows, gids = check_exact_live(card, rt, f"mutable megastep stage "
                                      f"{name}", r_np, mi, res.distances,
                                      res.indices, cfg.k)
        if name == "B":
            host_route_overfetch(card, rt, mi, cfg, r_np, res)
        fresh = rt.build_index(rows, cfg, device=DEV)
        ref = rt.knn_join_batched(r_np, index=fresh, batch_size=BUCKET,
                                  megastep=True, device=DEV)
        check_same_distances(f"stage {name}: mutable vs fresh index",
                             res.distances, ref.distances, res.indices,
                             gids[ref.indices], r_np, rows, gids=gids)
        print(f"[{card}] stage {name} ({key}): mutation {t_mut:.3f} s"
              + (f" (compact {mi.last_compact_s:.3f} s)" if name == "C"
                 else "")
              + f", payload refresh {t_refresh * 1e3:.3f} ms "
              f"({n_rebuilt:.0f} rebuild), step "
              f"{steps[key]:.4f} ms, join {t_join:.3f} s over {N_ROWS} "
              f"queries = {N_ROWS / t_join:.1f} queries/s, {st.n_batches} "
              f"batches, launches {counts}; bitwise equal to a fresh index "
              f"of the {rows.shape[0]} survivors", flush=True)
        if name != "A":
            continue
        profile_device(card, torch, lambda: eng.join_batch_device(qd, nv),
                       f"steady-state megastep over {n_segs} segments, "
                       f"{n_dead} tombstones (per step, {BUCKET} queries)",
                       out_dir / "mutable_profile.txt", runs=5)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = eng.join_batch_device(qd, nv)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        check(torch.equal(out[0][:BUCKET].cpu(), torch.as_tensor(
            res.distances[:BUCKET])), "stage A: the steady step differs")
        r_h = r_np[:HOST_ROWS]
        cfg_h = dataclasses.replace(cfg, n_groups=8, reducer="gather")
        host, t_host = synced(lambda: rt.knn_join(r_h, index=mi,
                                                  config=cfg_h, device=DEV))
        check_same_distances("stage A: host route vs megastep",
                             host.distances, res.distances[:HOST_ROWS],
                             host.indices, res.indices[:HOST_ROWS], r_h,
                             rows, gids=gids)
        cfg_q = dataclasses.replace(cfg_h, quant_slack=118)
        quant, t_quant = synced(lambda: rt.knn_join_batched(
            r_h, index=mi, config=cfg_q, batch_size=BUCKET, quantized=True,
            device=DEV))
        check_same_distances("stage A: quantized route vs megastep",
                             quant.distances, res.distances[:HOST_ROWS],
                             quant.indices, res.indices[:HOST_ROWS], r_h,
                             rows, gids=gids)
        fb = quant.stats.n_quant_fallback
        print(f"[{card}] stage A: one {n_segs}-segment join_batch_device with "
              f"no host sync under set_sync_debug_mode('error'); host route "
              f"(gather reducer) over {HOST_ROWS} queries {t_host:.3f} s, "
              f"quantized route {t_quant:.3f} s (certification fallbacks "
              f"{fb} = {fb / HOST_ROWS:.4%}), both bitwise equal to the "
              f"megastep", flush=True)
    print(f"[{card}] mutable megastep step ms ({BUCKET}-query bucket): "
          + ", ".join(f"{k} {v:.4f}" for k, v in steps.items()), flush=True)


def host_route_overfetch(card, rt, mi, cfg, r_np, res) -> None:
    """Stage B's host route (gather reducer) over ``HOST_ROWS`` queries:
    the probe queries' segment is re-fetched at k + its tombstones, so K-G
    runs with k far past 64 (its general kernel); bitwise equal to the
    megastep."""
    from repro_torch.kernels import distance_topk as kg
    ks = []
    kernel = kg.distance_topk_gather_cuda

    def spy(r, s, k, *args, **kw):
        ks.append(k)
        return kernel(r, s, k, *args, **kw)

    cfg_h = dataclasses.replace(cfg, n_groups=8, reducer="gather")
    kg.distance_topk_gather_cuda = spy
    try:
        t0 = time.perf_counter()
        host = rt.knn_join(r_np[:HOST_ROWS], index=mi, config=cfg_h,
                           device=DEV)
        t_host = time.perf_counter() - t0
    finally:
        kg.distance_topk_gather_cuda = kernel
    check(bool(ks) and max(ks) > 64,
          f"stage B: the host route never asked K-G for more than 64 rows "
          f"(k = {sorted(set(ks))})")
    rows, gids = mi.live_rows()
    check_same_distances("stage B: host route vs megastep", host.distances,
                         res.distances[:HOST_ROWS], host.indices,
                         res.indices[:HOST_ROWS], r_np[:HOST_ROWS], rows,
                         gids=gids)
    print(f"[{card}] stage B: host route (gather reducer) over {HOST_ROWS} "
          f"queries {t_host:.3f} s, K-G asked for k in {sorted(set(ks))} "
          f"(the over-fetch of the {PROBES} probe queries' segment), "
          f"bitwise equal to the megastep", flush=True)


def phase_retrieval(card, torch, rt, s_np, r_np, launches) -> None:
    """kNN-LM retrieval over a ``Datastore`` of the 522,911 base rows
    (values: seeded labels 0..6): 16 decode steps of 4,096 queries,
    each through both ``knn_logits`` routes; between steps 1,024
    held-out rows are added and 16 seeded live ids removed, and the
    store is compacted after step 8."""
    import numpy as np
    from repro_torch.kernels import ops
    from repro_torch.serve import (Datastore, KnnLMConfig, SchedulerConfig,
                                   ServeScheduler, knn_logits)
    vocab, k, n_steps = 7, 10, DECODE_STEPS
    labels = np.random.default_rng(12).integers(0, vocab, N_ROWS) \
        .astype(np.int32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    store = Datastore.build(s_np[:N_BASE], labels[:N_BASE], k=k,
                            n_pivots=256, device=DEV)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    d0, _, _ = store.retrieve(r_np[:BUCKET], k)
    tau = float(np.median(d0[:, -1].astype(np.float64) ** 2))
    kcfg = KnnLMConfig(k=k, tau=tau)
    print(f"[{card}] retrieval: Datastore.build {t_build:.3f} s over "
          f"{N_BASE} keys; tau = median k-th d² of step 0 = {tau:.6g}",
          flush=True)
    rng = np.random.default_rng(13)
    next_add = N_BASE
    ms = {"join": [], "kernel": [], "scheduler": []}
    # the scheduler route: one request of a whole step, on the exact rung
    sched = ServeScheduler.for_datastore(store, config=SchedulerConfig(
        batch_rows=BUCKET, degrade_queued_rows=BUCKET,
        shed_queued_rows=BUCKET, max_queued_rows=BUCKET))
    n_lp, n_swapped, lp_used = 0, 0, 0.0
    begin_path(ops, "retrieval")
    for step in range(n_steps):
        q = r_np[step * BUCKET:(step + 1) * BUCKET]
        out = {}
        for route, use_kernel in (("join", False), ("kernel", True)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out[route] = knn_logits(q, store, kcfg, vocab,
                                    use_kernel=use_kernel,
                                    return_neighbors=True)
            torch.cuda.synchronize()
            ms[route].append((time.perf_counter() - t0) * 1e3)
        lg_j, (d_j, i_j) = out["join"]
        lg_k, (d_k, i_k) = out["kernel"]
        what = f"retrieval step {step}"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg_s = knn_logits(q, store, kcfg, vocab, scheduler=sched,
                          deadline_s=60.0)
        ms["scheduler"].append((time.perf_counter() - t0) * 1e3)
        check(np.array_equal(lg_s, lg_j), f"{what}: the scheduler route's "
              f"log-probs are not bitwise the join route's")
        rows, gids = check_exact_live(card, rt, f"{what} join route", q,
                                      store.index, d_j, i_j, k,
                                      n_sample=256, report=False)
        # the routes against each other, on the rows K-D saw (centered)
        rows_c, center, _ = store.index.live_device_centered()
        q_c = torch.as_tensor(q, device=DEV) - center
        _, _, _, tol = check_runs(
            torch, f"{what}: kernel route vs join route", q_c, rows_c,
            torch.as_tensor(d_k, device=DEV),
            torch.as_tensor(live_positions(what, gids, i_k), device=DEV),
            torch.as_tensor(d_j, device=DEV),
            torch.as_tensor(live_positions(what, gids, i_j), device=DEV))
        # log-probs: a d² moved by at most δ moves each softmax logit by
        # δ/τ and a log-probability by at most 2·max δ/τ; allow 2·δ per
        # id (each route off the exact d² by up to the limit) plus 2⁻¹⁵
        # for float32 rounding of d², exp, the sums and log over the
        # range the 1e-9 floor leaves. Rows whose id sets differ (ties
        # at the k-th distance, checked above) are left out and counted.
        lp_tol = 4.0 * float(tol.max()) / tau + 2.0 ** -15
        same_set = (np.sort(i_j, axis=1) == np.sort(i_k, axis=1)).all(1)
        diff = (float(np.abs(lg_j[same_set] - lg_k[same_set]).max())
                if same_set.any() else 0.0)
        check(diff <= lp_tol, f"{what}: log-probs differ by {diff:.3e} > "
              f"{lp_tol:.3e}")
        n_lp += int(same_set.sum())
        n_swapped += int((~same_set).sum())
        lp_used = max(lp_used, diff / lp_tol)
        if step == n_steps - 1:
            break
        ids = store.add_entries(s_np[next_add:next_add + ADD_ROWS],
                                labels[next_add:next_add + ADD_ROWS])
        next_add += ADD_ROWS
        tomb = set(store.index.tombstones_sorted().tolist())
        live = np.setdiff1d(np.arange(int(ids[-1]) + 1),
                            np.fromiter(tomb, np.int64, len(tomb)))
        store.remove_entries(rng.choice(live, REMOVE_IDS, replace=False))
        if step == 8:
            store.compact()
            print(f"[{card}] retrieval: compact after step 8 took "
                  f"{store.index.last_compact_s:.3f} s", flush=True)
    counts = launches["retrieval"] = end_path(ops)
    check(counts["distance_topk"] == n_steps
          and counts["distance_topk_gather"] >= n_steps,
          f"retrieval: expected {n_steps} K-D launches and at least as "
          f"many K-G launches, got {counts}")
    check(sched.stats.n_completed == n_steps
          and sched.stats.n_degraded_requests == 0,
          f"retrieval: the scheduler route served {sched.stats}")
    print(f"[{card}] retrieval: {n_steps} decode steps x {BUCKET} queries, "
          f"vocab {vocab}; join route exact vs fp64 brute force (256 "
          f"sampled queries a step), routes' distances within the pair "
          f"limit; log-probs agree on {n_lp} rows (max {lp_used:.3e} of the "
          f"limit 4·max δ/τ + 2^-15), {n_swapped} rows with tie-swapped "
          f"ids; the scheduler route (ServeScheduler.for_datastore) bitwise "
          f"the join route every step; launches {counts}", flush=True)
    for route in ("join", "kernel", "scheduler"):
        print(f"[{card}] retrieval {route} route ms per step (refresh "
              f"included): " + ", ".join(f"{x:.3f}" for x in ms[route]),
              flush=True)


_ROW_KEYS = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms")


def attention_err(torch, out, ref) -> tuple[float, float]:
    """K-F's output against its plain version's: (max |err|, the share
    of the limit used). Both compute in float32 and round once to the
    output type, in another order of sums: float32 outputs agree within
    2e-5 abs, bfloat16 ones within one bf16 rounding (2⁻⁷ of the larger
    magnitude) plus 1e-6."""
    a, b = out.float(), ref.float()
    diff = (a - b).abs()
    if out.dtype == torch.bfloat16:
        lim = 2.0 ** -7 * torch.maximum(a.abs(), b.abs()) + 1e-6
    else:
        lim = torch.full_like(a, 2e-5)
    return float(diff.max()), float((diff / lim).max())


def attention_case(card, torch, what: str, q, k, v, *, window=None,
                   library=None, scale=None, d_v=None, causal: bool = True,
                   softcap: float = 0.0, k_new=None, v_new=None,
                   cancel: bool = False, library_name: str = "SDPA") -> dict:
    """K-F vs its plain version on one shape (causal or not, queries
    right-aligned), both timed, with ``library`` (one PyTorch call of the
    same function) timed beside them by ``device_ms``. ``softcap`` caps the logits;
    ``k_new`` / ``v_new`` are keys appended after k / v, read as K-F's
    second source (the read-only cache's decode). With ``cancel`` the
    limit is ``attention_err_terms``' (one bf16 rounding plus 2⁻¹⁴ of
    Σ p·|v|, phase 19's): outputs that cancel toward 0 carry float32 sum
    errors of the scale of what was summed, not of their own. ``d_v`` is the width of v the
    function uses (default all of it): MLA pads v with zeros (expanded
    form) or takes v = k and keeps the first 512 output columns
    (absorbed form). The bound is the larger of the bytes of q, k, the
    used columns of v (none where v is k) and of the kept output at the
    HBM rate, and the visible pairs' 2·(d + d_v) operations at the bf16
    tensor-core peak."""
    from repro_torch.kernels import flash_attention as kf
    b, nq, h, d = q.shape
    t_new = 0 if k_new is None else k_new.shape[1]
    nk, kvh = k.shape[1] + t_new, k.shape[2]
    d_v = v.shape[-1] if d_v is None else d_v
    kw = dict(window=window, scale=scale, causal=causal, softcap=softcap,
              k_new=k_new, v_new=v_new)
    out = kf.flash_attention_cuda(q, k, v, **kw)
    plan = kf.last_plan
    ref = kf.flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(out.float()).all()),
          f"K-F ({what}): non-finite output")
    if cancel:
        kw_abs = dict(kw, v_new=None if v_new is None else v_new.abs())
        err, used, old, *_ = attention_err_terms(
            torch, out, ref, kf.flash_attention_plain(q, k, v.abs(),
                                                      **kw_abs))
        print(f"[{card}] K-F ({what}): {old:.3f} of one bf16 rounding "
              f"alone, {used:.3f} of one rounding + 2^-14 sum p|v|",
              flush=True)
    else:
        err, used = attention_err(torch, out, ref)
    check(used <= 1.0, f"K-F ({what}): {used:.3f} of the limit against the "
          f"plain version")
    del ref, out
    ms = time_ms(lambda: kf.flash_attention_cuda(q, k, v, **kw), iters=10)
    plain_ms = time_ms(lambda: kf.flash_attention_plain(q, k, v, **kw),
                       warmup=1, iters=2)
    # the library call by device time: plain events read the host's
    # enqueue of its launches at the short shapes (PERF.md §6)
    lib_ms = None if library is None else device_ms(torch, library)
    pos = torch.arange(nq, device=DEV, dtype=torch.float64) + (nk - nq)
    lo = torch.zeros_like(pos) if window is None else \
        torch.clamp(pos - window + 1, min=0)
    hi = torch.full_like(pos, nk - 1)
    if causal:
        hi = torch.minimum(pos, hi)
    pairs = float(b * h * torch.clamp(hi - lo + 1, min=0).sum())
    n_bytes = float(q.element_size()) * (
        q.numel() + b * nq * h * d_v + b * nk * kvh * d
        + (0 if v is k else b * nk * kvh * d_v))
    t_b = n_bytes / H100_HBM_BYTES_S * 1e3
    t_f = 2.0 * (d + d_v) * pairs / H100_BF16_FLOPS_S * 1e3
    b_ms, b_by = (t_b, "bytes") if t_b >= t_f else (t_f, "operations")
    # the tensor-core form does 2d operations per pair for q·k and 3 x 2d
    # for the exact p·v over all d columns of v (p split in three bf16
    # terms): its own floor
    floor_ms = (max(t_b, 8.0 * d * pairs / H100_BF16_FLOPS_S * 1e3)
                if plan.route == "mma" else b_ms)
    print(f"[{card}] K-F flash attention ({what}) q {tuple(q.shape)} kv "
          f"{tuple(k.shape)} {str(q.dtype).removeprefix('torch.')}"
          + ("" if causal else " non-causal")
          + ("" if window is None else f" window {window}")
          + (f" cap {softcap}" if softcap else "")
          + (f" + {t_new} appended key(s) read in place" if t_new else "")
          + f", route {plan.route} (width {plan.width}, {plan.zc} column "
          f"chunks, {plan.splits} key splits of {plan.split_keys}): max "
          f"|err| {err:.3e} ({used:.3f} of the limit) vs the plain "
          f"version; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          + ("" if lib_ms is None else f"{library_name} {lib_ms:.4f} ms, ")
          + f"bound {b_ms:.4f} ms ({b_by}: {pairs:.4e} visible pairs x "
          f"2(d + d_v) = {2 * (d + d_v)} bf16 operations, {n_bytes:.4e} "
          f"bytes), this design's floor "
          f"{floor_ms:.4f} ms", flush=True)
    return dict(shape=what, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                form=plan.route, splits=plan.splits, softcap=softcap,
                appended=t_new)


def check_retrieval(card, torch, what: str, queries, keys64, kn64, d, ids,
                    k: int) -> None:
    """One retrieval against the float64 brute force over the live keys
    (on the card): distances within 4 ulp, every reported id's true
    distance within the true k-th, no duplicate ids."""
    import numpy as np
    q = torch.as_tensor(queries, device=DEV).double()
    d2 = torch.clamp((q * q).sum(1)[:, None] + kn64[None, :]
                     - 2.0 * (q @ keys64.T), min=0.0)
    bd2, _ = torch.topk(d2, k, dim=1, largest=False)
    bd = torch.sqrt(bd2).cpu().numpy()
    check(d.shape == (q.shape[0], k) and bool((ids >= 0).all()),
          f"{what}: malformed result")
    ulp = np.spacing(np.maximum(bd, 1.0).astype(np.float32))
    check(bool((np.abs(d - bd) <= 4 * ulp).all()),
          f"{what}: distances off the float64 brute force beyond 4 ulp")
    got = torch.gather(d2, 1, torch.as_tensor(ids, device=DEV).long())
    check(bool((got <= bd2[:, -1:] * (1 + 1e-6) + 1e-6).all()),
          f"{what}: a reported id lies beyond the true k-th distance")
    check(all(len(set(row)) == k for row in ids.tolist()),
          f"{what}: duplicate ids")


def tensor_core_instructions(card, name: str) -> int:
    """Tensor-core instructions (HGMMA, HMMA) in the SASS of one built
    kernel library (``cuobjdump -sass``); fails if there are none."""
    import os
    import re
    import shutil
    from repro_torch.kernels import build
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    check(os.path.exists(tool), "cuobjdump not found: cannot read K-F's SASS")
    sass = subprocess.run([tool, "-sass", str(build.library_path(name))],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    found = re.findall(r"\b(?:HGMMA|HMMA)\.[\w.]+", sass)
    check(len(found) > 0, f"{name}: no tensor-core instruction in its SASS")
    print(f"[{card}] {name} SASS: {len(found)} tensor-core instructions "
          f"({', '.join(sorted(set(found)))})", flush=True)
    return len(found)


def phase_lm(card, torch, rt, launches, out_dir: Path) -> dict:
    """14. The LM serving path at full width: llama3.2-3b in bf16 with
    seeded random weights, ``BatchedServer`` + ``make_knn_hook`` over a
    ``Datastore`` of 1,048,576 Gaussian keys. (a) K-F vs its plain version
    at the path's prefill and decode shapes and with a window, SDPA timed
    beside it; (b) 16 requests of 512-2,048 tokens, batch 8, 32 greedy
    tokens, counted (K-F once per layer per forward), every retrieval
    exact, every layer's K-F output of one prefill and one decode step
    held against the plain version, decode timed with and without the
    hook, and the device's busy share over decode steps with the hook
    profiled; (c) the reduced model on the card and on the CPU with the
    same weights: logits within tolerance, tokens equal."""
    import numpy as np
    import torch.nn.functional as F
    from repro_torch import configs
    from repro_torch.kernels import distance_topk as kg
    from repro_torch.kernels import flash_attention as kf
    from repro_torch.kernels import ops
    from repro_torch.models import (ModelOptions, count_params, forward,
                                    init_cache, init_params)
    from repro_torch.serve import (BatchedServer, Datastore, KnnLMConfig,
                                   ServeConfig, ServeScheduler,
                                   make_knn_hook, make_serve_step)
    cfg = configs.get_arch(LM_ARCH)
    h, kvh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.dh

    # ---- (a) K-F at the path's shapes
    gen = torch.Generator(device=DEV).manual_seed(14)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=DEV).to(torch.bfloat16)

    n = LM_PROMPT[1]
    q, k, v = rand(LM_BATCH, n, h, dh), rand(LM_BATCH, n, kvh, dh), \
        rand(LM_BATCH, n, kvh, dh)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    prefill = attention_case(
        card, torch, f"prefill b={LM_BATCH} nq=nk={n}", q, k, v,
        library=lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True))
    pos = torch.arange(n, device=DEV)
    wmask = ((pos[None, :] <= pos[:, None])
             & (pos[None, :] > pos[:, None] - 256))
    windowed = attention_case(
        card, torch, f"prefill b={LM_BATCH} nq=nk={n}, window 256", q, k, v,
        window=256, library=lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=wmask, enable_gqa=True))
    nk = n + LM_NEW
    kc, vc = rand(LM_BATCH, nk + 64, kvh, dh), rand(LM_BATCH, nk + 64, kvh, dh)
    q1 = rand(LM_BATCH, 1, h, dh)
    k1, v1 = kc[:, :nk], vc[:, :nk]          # a live slice of a cache
    q1t, k1t, v1t = (x.transpose(1, 2) for x in (q1, k1, v1))
    decode = attention_case(
        card, torch, f"decode b={LM_BATCH} nq=1 nk={nk}", q1, k1, v1,
        library=lambda: F.scaled_dot_product_attention(
            q1t, k1t, v1t, enable_gqa=True))
    del q, k, v, qt, kt, vt, kc, vc, q1, k1, v1, q1t, k1t, v1t, wmask
    # a head width no kernel is instantiated for (MLA's q·k width)
    q, k, v = rand(2, n, h, 192), rand(2, n, kvh, 192), rand(2, n, kvh, 192)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    wide = attention_case(
        card, torch, f"prefill b=2 nq=nk={n}, d=192", q, k, v,
        library=lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True))
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    n_mma = tensor_core_instructions(card, "flash_attn")

    # ---- (b) BatchedServer + the kNN-LM hook, counted
    opts = ModelOptions(dtype=torch.bfloat16)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=DEV).manual_seed(0),
                         opts, device=DEV)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_params = count_params(params)
    rng = np.random.default_rng(14)
    keys = rng.standard_normal((LM_STORE_KEYS, LM_STORE_DIM),
                               dtype=np.float32)
    vals = rng.integers(0, cfg.vocab, LM_STORE_KEYS).astype(np.int32)
    prompts = [rng.integers(0, cfg.vocab, int(rng.integers(
        LM_PROMPT[0], LM_PROMPT[1] + 1))).astype(np.int32)
        for _ in range(LM_REQUESTS)]
    kcfg = KnnLMConfig(lam=0.2, tau=50.0, k=8)
    begin_path(ops, "lm_serve")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    store = Datastore.build(keys, vals, k=8, n_pivots=128, n_groups=8,
                            device=DEV)
    torch.cuda.synchronize()
    t_store = time.perf_counter() - t0
    retrieved = []
    retrieve = record_retrievals(store, retrieved)
    hook = make_knn_hook(store, kcfg, cfg.vocab)
    prefill_ms, decode_ms, hook_ms = [], [], []
    srv = BatchedServer(cfg, ServeConfig(batch=LM_BATCH), params, opts,
                        logits_hook=timed(hook, hook_ms))
    srv.prefill_step = timed(srv.prefill_step, prefill_ms)
    srv.decode_step = timed(srv.decode_step, decode_ms)
    t0 = time.perf_counter()
    outs = srv.generate(prompts, max_new_tokens=LM_NEW)
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    counts = launches["lm_serve"] = end_path(ops)
    peak = torch.cuda.max_memory_allocated()
    waves = -(-LM_REQUESTS // LM_BATCH)
    want_fa = cfg.n_layers * waves * (LM_NEW + 1)
    check(counts["flash_attention"] == want_fa,
          f"LM serving: K-F launched {counts['flash_attention']} times, "
          f"expected {cfg.n_layers} layers x {waves} waves x {LM_NEW + 1} "
          f"forwards = {want_fa}")
    check(counts["distance_topk_gather"] >= waves * LM_NEW
          and counts["assign"] > 0,
          f"LM serving: K-G must launch once a decode step at least and K-A "
          f"in the Datastore build: {counts}")
    check(len(outs) == LM_REQUESTS and all(
        o.shape == (LM_NEW,) and ((o >= 0) & (o < cfg.vocab)).all()
        for o in outs), "LM serving: malformed generations")
    check(len(retrieved) == waves * LM_NEW,
          f"LM serving: {len(retrieved)} retrievals for "
          f"{waves * LM_NEW} decode steps")
    keys64 = torch.as_tensor(keys, device=DEV).double()
    kn64 = (keys64 * keys64).sum(1)
    for i, (qr, d, ids) in enumerate(retrieved):
        check_retrieval(card, torch, f"decode step {i} retrieval", qr, keys64,
                        kn64, d, ids, kcfg.k)
    del keys64, kn64
    n_tok = LM_REQUESTS * LM_NEW
    print(f"[{card}] LM serving {LM_ARCH} (bf16, {n_params} parameters, "
          f"init {t_init:.3f} s): Datastore.build {t_store:.3f} s over "
          f"{LM_STORE_KEYS} keys x {LM_STORE_DIM}; {LM_REQUESTS} requests of "
          f"{min(map(len, prompts))}-{max(map(len, prompts))} prompt tokens, "
          f"batch {LM_BATCH}, {LM_NEW} greedy tokens each in {t_gen:.3f} s "
          f"= {n_tok / t_gen:.1f} tokens/s with the kNN-LM hook; peak memory "
          f"{peak / 2 ** 30:.3f} GiB; launches {counts}; every retrieval "
          f"({len(retrieved)}) exact vs the float64 brute force", flush=True)
    print(f"[{card}] LM serving prefill ms per wave: "
          + ", ".join(f"{x:.3f}" for x in prefill_ms), flush=True)
    print(f"[{card}] LM serving decode ms per step (model only; median "
          f"{float(np.median(decode_ms)):.3f}): "
          + ", ".join(f"{x:.3f}" for x in decode_ms), flush=True)
    print(f"[{card}] LM serving kNN-LM hook ms per step (median "
          f"{float(np.median(hook_ms)):.3f}): "
          + ", ".join(f"{x:.3f}" for x in hook_ms), flush=True)

    # K-G alone at one decode step's retrieval (8 queries, 1M keys)
    seen = {}
    kernel = kg.distance_topk_gather_cuda

    def grab(r, s, k, schedule, counts, **kw):
        seen.update(r=r, s=s, k=k, schedule=schedule, counts=counts, **kw)
        return kernel(r, s, k, schedule, counts, **kw)

    kg.distance_topk_gather_cuda = grab
    try:
        store.retrieve(retrieved[0][0], kcfg.k)
    finally:
        kg.distance_topk_gather_cuda = kernel
    alive = seen.get("alive")
    g = dict(qcs=seen["r"], s_c=seen["s"], sched=seen["schedule"],
             cnt=seen["counts"], bm=seen["bm"], bn=seen["bn"],
             alive=torch.ones(seen["s"].shape[0], device=DEV)
             if alive is None else alive)
    kg_decode = gather_case(card, torch, f"kNN-LM decode step: "
                            f"{retrieved[0][0].shape[0]} queries over "
                            f"{LM_STORE_KEYS} keys", g, seen["k"],
                            plain_iters=1)
    del g, seen

    # every layer's K-F output of one prefill and one decode step vs plain
    errs = []
    flash = ops.flash_attention

    def checking(q, k, v, **kw):
        out = flash(q, k, v, **kw)
        errs.append(attention_err(torch, out, kf.flash_attention_plain(
            q, k, v, **kw)))
        return out

    prefill_step, decode_step = make_serve_step(cfg, ServeConfig(), opts)
    wave = prompts[:LM_BATCH]
    tmax = max(len(p) for p in wave)
    pad = np.zeros((len(wave), tmax), np.int32)
    for r, p in enumerate(wave):
        pad[r, tmax - len(p):] = p
    ops.flash_attention = checking
    try:
        cache = init_cache(cfg, len(wave), tmax + 8, opts, device=DEV)
        logits, cache = prefill_step(params, torch.as_tensor(pad, device=DEV),
                                     cache)
        tok = torch.argmax(logits, -1).to(torch.int32)
        logits, cache = decode_step(params, tok[:, None], cache)
    finally:
        ops.flash_attention = flash
    torch.cuda.synchronize()
    check(len(errs) == 2 * cfg.n_layers,
          f"layer check: {len(errs)} K-F calls, expected {2 * cfg.n_layers}")
    worst = max(u for _, u in errs)
    check(worst <= 1.0, f"layer check: a layer's K-F output is {worst:.3f} "
          f"of the limit off its plain version")
    print(f"[{card}] LM serving layer check: all {cfg.n_layers} layers' K-F "
          f"outputs of one prefill (b={len(wave)}, {tmax} tokens) and one "
          f"decode step vs the plain version on the same q/k/v: max |err| "
          f"{max(e for e, _ in errs):.3e}, {worst:.3f} of the bf16 limit",
          flush=True)
    state = {"logits": logits}

    def step():     # one decode step of the served loop: hook, sample, decode
        tok = torch.argmax(hook(state["logits"], cache), -1).to(torch.int32)
        state["logits"], _ = decode_step(params, tok[:, None], cache)

    profile_device(card, torch, step, f"LM decode step with the kNN-LM hook "
                   f"(b={len(wave)}, cache {tmax + 1}+)",
                   out_dir / "lm_decode_profile.txt", runs=4)
    del cache, logits, state
    plain_ms = []
    srv0 = BatchedServer(cfg, ServeConfig(batch=LM_BATCH), params, opts)
    srv0.decode_step = timed(srv0.decode_step, plain_ms)
    srv0.generate(prompts[:LM_BATCH], max_new_tokens=LM_NEW)
    print(f"[{card}] LM serving decode ms per step without the hook (one "
          f"wave; median {float(np.median(plain_ms)):.3f}): "
          + ", ".join(f"{x:.3f}" for x in plain_ms), flush=True)

    # one more wave with the hook through the serving scheduler, counted:
    # its tokens equal the direct hook's on the same prompts
    store.retrieve = retrieve
    sched = ServeScheduler.for_datastore(store)
    begin_path(ops, "lm_serve_sched")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    via = BatchedServer(
        cfg, ServeConfig(batch=LM_BATCH), params, opts,
        logits_hook=make_knn_hook(store, kcfg, cfg.vocab, scheduler=sched,
                                  deadline_s=60.0)).generate(
        prompts[:LM_BATCH], max_new_tokens=SCHED_NEW)
    torch.cuda.synchronize()
    t_sched = time.perf_counter() - t0
    counts_s = launches["lm_serve_sched"] = end_path(ops)
    check(all(np.array_equal(a, b[:SCHED_NEW])
              for a, b in zip(via, outs[:LM_BATCH])),
          "LM serving: tokens through the scheduler's hook differ from the "
          "direct hook's")
    st = sched.snapshot()
    check(st.n_completed == SCHED_NEW and st.n_degraded_requests == 0
          and st.n_expired_dispatched == 0,
          f"LM serving: the scheduler's hook served {st}")
    check(counts_s["flash_attention"] == cfg.n_layers * (SCHED_NEW + 1)
          and counts_s["distance_topk_gather"] >= SCHED_NEW,
          f"LM serving through the scheduler: launches {counts_s}")
    print(f"[{card}] LM serving through ServeScheduler: {LM_BATCH} requests "
          f"x {SCHED_NEW} greedy tokens in {t_sched:.3f} s, tokens equal to "
          f"the direct hook's; {st.n_completed} retrievals served exact; "
          f"launches {counts_s}", flush=True)
    del params, srv, srv0, store
    torch.cuda.empty_cache()

    # ---- (c) the reduced model: card vs CPU, the same weights
    cfg_r = configs.get_reduced(LM_ARCH)
    opts32 = ModelOptions(dtype=torch.float32)
    cpu_params = init_params(cfg_r, torch.Generator().manual_seed(2), opts32,
                             device="cpu")

    dev_params = to_device(cpu_params)
    toks = torch.as_tensor(rng.integers(0, cfg_r.vocab, (4, 300)))
    lg_cpu, _ = forward(cpu_params, cfg_r, toks, opts=opts32)
    lg_dev, _ = forward(dev_params, cfg_r, toks.to(DEV), opts=opts32)
    again, _ = forward(dev_params, cfg_r, toks.to(DEV), opts=opts32)
    check(torch.equal(lg_dev, again),
          "reduced model: two identical forwards on the card differ")
    del again
    ops.flash_attention = kf.flash_attention_plain
    try:
        lg_dev_plain, _ = forward(dev_params, cfg_r, toks.to(DEV), opts=opts32)
    finally:
        ops.flash_attention = flash
    lg_dev, lg_dev_plain = lg_dev.cpu(), lg_dev_plain.cpu()
    # K-F's share: the card's logits with K-F and with the plain attention
    # on the card, both fp32 (the fp32 limit of attention_err, 2e-5, per
    # unit of logit)
    kf_diff = float((lg_dev - lg_dev_plain).abs().max())
    check(bool(((lg_dev - lg_dev_plain).abs()
                <= 2e-5 + 2e-5 * lg_dev_plain.abs()).all()),
          f"reduced model: K-F moves the card's logits by {kf_diff:.3e}")
    # card vs CPU: the same fp32 function on both devices. The RoPE
    # tables (frequencies, cos, sin) are taken in float64 and rounded once,
    # so both devices hold the same float32 tables; what is left is each
    # device's order of sums and its float32 exp / rsqrt / silu, within
    # 2e-5 + 2e-5·|logit|.
    from repro_torch.models.layers import rope_tables
    tables = []
    for where in ("cpu", DEV):
        pos = torch.arange(300, device=where)[None, :]
        tables.append(torch.cat(rope_tables(pos, cfg_r.dh // 2,
                                            cfg_r.rope_theta)).cpu())
    table_diff = float((tables[0] - tables[1]).abs().max())
    diff = float((lg_dev - lg_cpu).abs().max())
    plain_diff = float((lg_dev_plain - lg_cpu).abs().max())
    isa = f"{torch.backends.cpu.get_cpu_capability()}, {cpu_line()}"
    check(table_diff == 0.0, f"reduced model: RoPE tables differ card vs CPU "
          f"({isa}) by {table_diff:.3e}")
    check(bool(((lg_dev - lg_cpu).abs() <= 2e-5 + 2e-5 * lg_cpu.abs()).all()),
          f"reduced model: card logits off the CPU's by {diff:.3e}, past "
          f"2e-5 + 2e-5·|logit| (with the plain attention on the card "
          f"{plain_diff:.3e}; K-F vs the plain attention on the card "
          f"{kf_diff:.3e}; CPU {isa})")
    small = [rng.integers(0, cfg_r.vocab, int(n)).astype(np.int32)
             for n in (5, 130, 3, 260, 40)]
    got = {}
    for where, p in (("cpu", cpu_params), ("card", dev_params)):
        got[where] = BatchedServer(cfg_r, ServeConfig(batch=2), p,
                                   opts32).generate(small, max_new_tokens=8)
    check(all(np.array_equal(a, b) for a, b in zip(got["cpu"], got["card"])),
          "reduced model: greedy tokens differ between card and CPU")
    print(f"[{card}] reduced {LM_ARCH} (fp32, {count_params(cpu_params)} "
          f"parameters): card vs CPU logits over 4 x 300 tokens max |diff| "
          f"{diff:.3e} (limit 2e-5 + 2e-5·|logit|; with the plain attention "
          f"on the card {plain_diff:.3e}; RoPE cos/sin tables card vs CPU "
          f"({isa}) bitwise equal), K-F vs the plain attention on the "
          f"card {kf_diff:.3e} (limit 2e-5 + 2e-5·|logit|); a repeated "
          f"forward on the card bitwise equal; greedy tokens of 5 requests "
          f"(batch 2, 8 tokens) equal", flush=True)

    row = dict(name="flash_attention", route="cuda",
               source="src/repro_torch/csrc/flash_attn.cu",
               replaces="src/repro/kernels/flash_attention.py:27")
    row.update({key: prefill[key] for key in _ROW_KEYS})
    row["other_shapes"] = [decode, windowed, wide]
    row["tensor_core_instructions"] = n_mma
    row["lm_serve"] = dict(
        tokens_per_s=n_tok / t_gen, prefill_ms=prefill_ms,
        decode_ms_median=float(np.median(decode_ms)),
        hook_ms_median=float(np.median(hook_ms)),
        decode_ms_median_no_hook=float(np.median(plain_ms)),
        peak_bytes=peak, kg_decode_step=kg_decode)
    return row


def phase_caps(card, torch, rt, s_np, r_np, cfg, g_forest) -> dict:
    """13. The shapes the kernels refused before: K-A at d = 3,072, K-G at
    d = 256 / 1,024 and at k = 100 / 1,024, K-D at k = 128, K-Q at d =
    256 and at mp = 1,024 — each against its plain version, as its own
    phase checks it; and K-G's widest register form (d = 128, k = 64).
    Returns the cases per kernel."""
    import numpy as np
    from repro_torch.kernels import distance_topk as kd
    caps = {"assign": [], "distance_topk_gather": [], "distance_topk": [],
            "quant_coarse_gather": []}
    gen = torch.Generator(device=DEV).manual_seed(13)
    x = torch.randn((CAP_ROWS, 3072), generator=gen, device=DEV)
    piv = torch.randn((256, 3072), generator=gen, device=DEV)
    a = phase_assign(card, torch, rt, x, piv)
    caps["assign"].append(dict(
        shape=f"d = 3,072: {CAP_ROWS} Gaussian rows x 256 pivots",
        **{k: a[k] for k in _ROW_KEYS + ("device_ms", "form", "splits")}))
    del x, piv
    rng = np.random.default_rng(13)
    cfg_g = rt.JoinConfig(k=10, n_pivots=256, tile_r=128, tile_s=512)
    for d, k in ((128, 64), (256, 10), (1024, 10)):
        s_g = rng.standard_normal((CAP_ROWS, d), dtype=np.float32)
        r_g = rng.standard_normal((BUCKET, d), dtype=np.float32)
        g = gather_inputs(torch, rt, s_g, r_g, cfg_g)
        caps["distance_topk_gather"].append(gather_case(
            card, torch, f"d = {d}, k = {k}, {CAP_ROWS} Gaussian rows", g, k))
        del g
        torch.cuda.empty_cache()
    for k in (100, 1024):
        caps["distance_topk_gather"].append(gather_case(
            card, torch, f"Forest bucket, k = {k}", g_forest, k,
            plain_iters=1))
    base = torch.as_tensor(s_np[:N_BASE], device=DEV)
    center = base.double().mean(0).float()
    s_c = (base - center).contiguous()
    q_c = (torch.as_tensor(r_np[:BUCKET], device=DEV) - center).contiguous()
    caps["distance_topk"].append(dense_case(
        card, torch, kd, "a: retrieval shape, k = 128", q_c, s_c, 128, None,
        library=True))
    del base, s_c, q_c
    s_q = rng.standard_normal((CAP_ROWS, 256), dtype=np.float32)
    r_q = rng.standard_normal((BUCKET, 256), dtype=np.float32)
    cfg_q = dataclasses.replace(cfg_g, quant_slack=118, reducer="gather")
    row = phase_quant(card, torch, rt,
                      rt.build_index(s_q, cfg_q, quantize="int8", device=DEV),
                      r_q, cfg_q, plain_iters=1)
    caps["quant_coarse_gather"].append(dict(
        shape=f"d = 256, {CAP_ROWS} Gaussian rows, mp = 128",
        **{k: row[k] for k in _ROW_KEYS + ("form", "splits")}))
    cfg_m = dataclasses.replace(cfg, quant_slack=1014, reducer="gather")
    row = phase_quant(card, torch, rt,
                      rt.build_index(s_np, cfg_m, quantize="int8", device=DEV),
                      r_np, cfg_m, plain_iters=1)
    caps["quant_coarse_gather"].append(dict(
        shape="Forest bucket, mp = 1,024",
        **{k: row[k] for k in _ROW_KEYS + ("form", "splits")}))
    torch.cuda.empty_cache()
    return caps


def profile_device(card, torch, fn, what: str, out_file: Path,
                   runs: int = 1) -> None:
    """Device time by kernel over ``runs`` calls of ``fn`` (torch.profiler),
    and the device's busy share of the same window's CUDA-event time.
    The profiler's host overhead lengthens the window, so the busy share
    is a lower bound. A profiler that records no device time on this
    machine is reported as not measured; an error in ``fn`` fails the
    run."""
    from torch.profiler import ProfilerActivity, profile
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(runs):
            fn()
        end.record()
        torch.cuda.synchronize()
    wall = start.elapsed_time(end) / runs
    kernels = [(e.key, e.self_device_time_total / 1e3 / runs)
               for e in prof.key_averages()
               if e.device_type.name == "CUDA" and e.self_device_time_total > 0]
    busy = sum(ms for _, ms in kernels)
    if not busy:
        print(f"[{card}] {what} profile: not measured (no device time "
              f"recorded)", flush=True)
        return
    kernels.sort(key=lambda kv: -kv[1])
    out_file.write_text(
        "".join(f"{ms:10.4f} ms  {name}\n" for name, ms in kernels))
    top = ", ".join(f"{name[:48]} {ms / busy:.1%}" for name, ms in kernels[:3])
    print(f"[{card}] {what} profile: {len(kernels)} kernels, device busy "
          f"{busy:.4f} ms of {wall:.4f} ms under the profiler "
          f"({busy / wall:.1%}); top: {top}", flush=True)


def check_oracle(what: str, x_q, x_s, d, i, bd, bi, metric: str = "l2"
                 ) -> float:
    """A join's result against the float64 oracle's ``(bd, bi)`` over
    every query: distances bit for bit (both report the canonical
    chain), every reported id at most the true k-th distance away under
    the metric (float64, near-ties allowed: 1e-6 relative), no duplicate
    ids in a row. Returns the share of ids equal to the oracle's."""
    import numpy as np
    check(d.shape == bd.shape and bool(np.isfinite(d).all())
          and bool((i >= 0).all()), f"{what}: malformed result")
    check(np.array_equal(d, bd),
          f"{what}: distances not bitwise the float64 oracle's")
    srt = np.sort(i, axis=1)
    check(bool((srt[:, 1:] != srt[:, :-1]).all()),
          f"{what}: duplicate ids in a row")
    q64, s64 = x_q.astype(np.float64), x_s.astype(np.float64)

    def dist(ids):
        out = np.empty(ids.shape)
        for lo in range(0, ids.shape[0], 8192):
            diff = np.abs(q64[lo:lo + 8192, None, :] - s64[ids[lo:lo + 8192]])
            out[lo:lo + 8192] = (np.sqrt((diff ** 2).sum(-1)) if metric == "l2"
                                 else diff.sum(-1) if metric == "l1"
                                 else diff.max(-1))
        return out

    check(bool((dist(i) <= dist(bi[:, -1:]) * (1 + 1e-6) + 1e-6).all()),
          f"{what}: a reported id lies beyond the true k-th distance")
    return float((i == bi).mean())


def phase_paper(card, torch, rt, launches) -> dict:
    """16. The paper's §6 comparison at its ``_three_way`` settings (k =
    10, 9 reducers, 128 pivots): PGBJ (``knn_join``), PBJ and H-BRJ
    self-joins of ``PAPER_ROWS`` Forest-like and OSM-like rows, each
    counted and held bitwise against the float64 oracle; one L1 and one
    L∞ ``knn_join`` of the Forest rows against the new oracle; and
    ``launch.join --expand 2 --verify`` over 2 × ``EXPAND_ROWS`` rows
    (Forest×2) in a subprocess."""
    import os
    import numpy as np
    from repro_torch.kernels import ops
    t_phase = time.perf_counter()
    k, out = PAPER_K, {}
    data = {"forest": rt.forest_like(PAPER_ROWS, DIM, seed=16),
            "osm": rt.osm_like(PAPER_ROWS, seed=16)}
    for name, x in data.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bd, bi = rt.brute_force_knn(x, x, k, device=DEV)
        t_oracle = time.perf_counter() - t0
        runs = {
            "pgbj": lambda: rt.knn_join(x, x, config=rt.JoinConfig(
                k=k, n_pivots=PAPER_PIVOTS, n_groups=PAPER_REDUCERS),
                device=DEV),
            "pbj": lambda: rt.pbj_join(
                x, x, k, rt.JoinConfig(k=k, n_pivots=PAPER_PIVOTS),
                n_reducers=PAPER_REDUCERS, device=DEV),
            "hbrj": lambda: rt.hbrj_join(x, x, k, n_reducers=PAPER_REDUCERS,
                                         device=DEV)}
        for method, run in runs.items():
            path = f"paper_{method}_{name}"
            begin_path(ops, path)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = launches[path] = end_path(ops)
            same = check_oracle(f"{method} on {name}", x, x, res.distances,
                                res.indices, bd, bi)
            st = res.stats
            out[path] = dict(wall_s=wall, selectivity=st.selectivity,
                             shuffle_tuples=st.shuffle_tuples,
                             alpha=st.replicas_s / st.n_s,
                             tile_selectivity=st.tile_selectivity)
            print(f"[{card}] paper §6 {method} on {name} ({PAPER_ROWS} rows, "
                  f"self-join, k {k}, {PAPER_REDUCERS} reducers, "
                  f"{PAPER_PIVOTS} pivots): wall {wall:.3f} s, selectivity "
                  f"{st.selectivity:.6f}, shuffle_tuples {st.shuffle_tuples}, "
                  f"alpha {st.replicas_s / st.n_s:.4f}; distances bitwise the "
                  f"float64 oracle's ({t_oracle:.3f} s), ids equal "
                  f"{same:.6f} (rest ties); launches {counts}", flush=True)
        # the §6 setting's reducer is "auto" = pruned (host ops, as in the
        # JAX package), so K-G does not run; K-A assigns R and S
        check(launches[f"paper_pgbj_{name}"]["assign"] > 0,
              f"paper §6: PGBJ on {name} did not run K-A: "
              f"{launches[f'paper_pgbj_{name}']}")
        check(launches[f"paper_pbj_{name}"]["assign"] >= 2,
              f"paper §6: PBJ on {name} did not run K-A on R and S: "
              f"{launches[f'paper_pbj_{name}']}")
    x = data["forest"]
    for metric in ("l1", "linf"):
        path = f"paper_{metric}_forest"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bd, bi = rt.brute_force_knn(x, x, k, metric=metric, device=DEV)
        t_oracle = time.perf_counter() - t0
        begin_path(ops, path)
        t0 = time.perf_counter()
        res = rt.knn_join(x, x, config=rt.JoinConfig(
            k=k, n_pivots=PAPER_PIVOTS, n_groups=PAPER_REDUCERS,
            metric=metric), device=DEV)
        wall = time.perf_counter() - t0
        counts = launches[path] = end_path(ops)
        same = check_oracle(f"{metric} knn_join on forest", x, x,
                            res.distances, res.indices, bd, bi, metric)
        out[path] = dict(wall_s=wall, selectivity=res.stats.selectivity,
                         oracle_s=t_oracle)
        print(f"[{card}] paper §6 {metric} knn_join on forest ({PAPER_ROWS} "
              f"rows, self-join): wall {wall:.3f} s, selectivity "
              f"{res.stats.selectivity:.6f}; distances bitwise the {metric} "
              f"float64 oracle's ({t_oracle:.3f} s), ids equal {same:.6f}; "
              f"launches {counts}", flush=True)
    cmd = [sys.executable, "-m", "repro_torch.launch.join", "--dataset",
           "forest", "--n", str(EXPAND_ROWS), "--expand", "2", "--k", "10",
           "--pivots", "256", "--groups", "9", "--verify"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, env=env, cwd=ROOT, capture_output=True,
                          text=True, timeout=900)
    wall = time.perf_counter() - t0
    for line in proc.stdout.strip().splitlines():
        print(f"[{card}] launch.join: {line}", flush=True)
    check(proc.returncode == 0
          and f"n={2 * EXPAND_ROWS} " in proc.stdout
          and "verified vs brute force on 500 samples: True" in proc.stdout,
          f"launch.join --expand 2 --verify failed (rc {proc.returncode}): "
          f"{proc.stdout[-2000:]} {proc.stderr[-2000:]}")
    out["launch_join_expand2_s"] = wall
    print(f"[{card}] phase 16 (paper §6 comparison) took "
          f"{time.perf_counter() - t_phase:.3f} s (launch.join subprocess "
          f"{wall:.3f} s)", flush=True)
    return out


def phase_serving(card, torch, rt, idx_q, cfg_q, r_np, s_np, ref_d,
                  launches) -> dict:
    """17. Serving under load through ``ServeScheduler`` in front of a
    quantized ``StreamJoinEngine`` over phase 8's Forest index: ``dispatch``
    under the sync debug mode; ``join_now`` bitwise ``join_batch``,
    synchronously and with ``max_inflight=2``; faults at ``sched.dispatch``
    and ``megastep.fetch`` retried onto the host path; then open-loop
    bursty traffic of ``SERVE_ROWS``-row requests (a quarter bulk) on a
    ``VirtualClock`` with measured service times, at 0.8× and 2× the
    saturation rate measured here, under the default ``SchedulerConfig``
    and under ``batch_rows=4096``."""
    import numpy as np
    from repro_torch.kernels import ops
    from repro_torch.serve import (Arrival, FaultPlan, LoadReport, Priority,
                                   SchedulerConfig, ServeScheduler,
                                   VirtualClock, bursty_times, run_open_loop)
    t_phase = time.perf_counter()
    k = cfg_q.k
    eng = rt.StreamJoinEngine(idx_q, cfg_q, quantized=True, device=DEV)
    me = eng.megastep_engine
    check(me.mode == "int8" and me.resident,
          "serving: expected the resident int8 engine")
    fp32 = rt.StreamJoinEngine(idx_q, cfg_q, megastep=True, quantized=False,
                               device=DEV)
    # (a) dispatch makes no host sync: the upload is a pinned async copy
    q = r_np[:BUCKET]
    for what, e in (("fp32 megastep", fp32), ("quantized", eng)):
        want = e.join_batch(q)         # warm: payload, staging buffer
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            handle = e.dispatch(q)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        got = e.finalize(handle)
        check(np.array_equal(got[0], want[0])
              and np.array_equal(got[1], want[1]),
              f"serving: {what} dispatch + finalize differs from join_batch")
    print(f"[{card}] serving: dispatch of a {BUCKET}-query batch (fp32 "
          f"megastep and quantized engine) under set_sync_debug_mode("
          f"'error'): no host sync; finalize bitwise join_batch", flush=True)
    # (b) the gate of the JAX package's bench, and (c) faults, counted
    q = r_np[BUCKET:BUCKET + 512]
    want = eng.join_batch(q)
    begin_path(ops, "serving_faults")
    for mi in (1, 2):
        t = ServeScheduler(eng, config=SchedulerConfig(max_inflight=mi)) \
            .join_now(q, deadline_s=60.0)
        check(t.done and not t.degraded
              and np.array_equal(t.distances, want[0])
              and np.array_equal(t.indices, want[1]),
              f"serving: join_now (max_inflight={mi}) is not bitwise "
              f"join_batch")
    for site, mi in (("sched.dispatch", 1), ("megastep.fetch", 2)):
        with FaultPlan().fail(site, times=1) as plan:
            sched = ServeScheduler(eng, config=SchedulerConfig(
                max_inflight=mi), sleep=lambda _s: None)
            t = sched.join_now(q, deadline_s=60.0)
        check(plan.fired[site] >= 1 and t.done and t.attempts == 2
              and sched.stats.n_retries == 1,
              f"serving: a fault at {site} (max_inflight={mi}) was not "
              f"retried onto the host path")
        # the host path reports the same canonical distances; Forest-like
        # rows tie, and a tie may list another id
        check_same_distances(f"serving: the host-path retry after a fault "
                             f"at {site}", t.distances, want[0], t.indices,
                             want[1], q, s_np)
    counts = launches["serving_faults"] = end_path(ops)
    check(counts["distance_topk_gather"] > 0 and counts["assign"] > 0,
          f"serving: the host-path retries ran no K-A / K-G: {counts}")
    print(f"[{card}] serving: join_now bitwise join_batch (max_inflight 1 "
          f"and 2); faults at sched.dispatch and megastep.fetch retried "
          f"onto the host path, distances bitwise (ids but at ties); "
          f"launches {counts}", flush=True)
    # does the double-buffered rung overlap now that dispatch is async?
    # 32 whole buckets through the fp32 megastep, max_inflight 1 and 2 in
    # turns (1, 2, 2, 1), wall time of the drain
    reqs = [r_np[j * BUCKET:(j + 1) * BUCKET] for j in range(32)]
    walls = {1: [], 2: []}
    for mi in (1, 2, 2, 1):
        sched = ServeScheduler(fp32, config=SchedulerConfig(
            batch_rows=BUCKET, max_queued_rows=32 * BUCKET,
            degrade_queued_rows=32 * BUCKET, shed_queued_rows=32 * BUCKET,
            max_inflight=mi))
        tickets = [sched.submit(q, deadline_s=600.0) for q in reqs]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sched.drain()
        walls[mi].append(time.perf_counter() - t0)
        check(all(t.done and not t.degraded for t in tickets)
              and np.array_equal(tickets[0].distances, ref_d[:BUCKET]),
              f"serving: the max_inflight={mi} drain is not exact")
    print(f"[{card}] serving: 32 x {BUCKET}-query batches through the fp32 "
          f"megastep, drain wall s with max_inflight 1: "
          + ", ".join(f"{w:.4f}" for w in walls[1]) + "; with 2: "
          + ", ".join(f"{w:.4f}" for w in walls[2]), flush=True)

    # (d) open loop at 0.8x and 2x of the saturation rate, counted
    rng = np.random.default_rng(17)

    def service_s(rows: int) -> float:
        """Median wall time of one exact batch of ``rows`` query rows."""
        ts = []
        for j in range(5):
            lo = (j * rows * 7) % (N_ROWS - rows)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.join_batch(r_np[lo:lo + rows])
            ts.append(time.perf_counter() - t0)
        return float(np.median(ts))

    out = {"pipelined_drain_s": walls}
    # service times first: their warm-up joins run no scheduler, so the
    # counts below are the scheduler runs' alone
    configs = [(label, scfg, service_s(scfg.batch_rows))
               for label, scfg in (("default", SchedulerConfig()),
                                   (f"batch_rows={BUCKET}",
                                    SchedulerConfig(batch_rows=BUCKET)))]
    begin_path(ops, "serving_load")
    for label, scfg, svc in configs:
        sat = scfg.batch_rows / svc / SERVE_ROWS     # requests/s
        for load in (0.8, 2.0):
            rate = load * sat
            dur = SERVE_REQUESTS * 1.05 / rate
            times = bursty_times(rate, dur, rng)
            while times.size < SERVE_REQUESTS:
                dur *= 1.2
                times = bursty_times(rate, dur, rng)
            starts = rng.integers(0, N_ROWS - SERVE_ROWS, times.size)
            arrivals = [Arrival(t=float(tt), rows=r_np[s0:s0 + SERVE_ROWS],
                                priority=Priority.BULK if j % 4 == 0
                                else Priority.INTERACTIVE)
                        for j, (tt, s0) in enumerate(zip(times, starts))]
            vc = VirtualClock()
            sched = ServeScheduler(eng, config=scfg, clock=vc.now,
                                   sleep=vc.advance)
            t0 = time.perf_counter()
            tickets = run_open_loop(sched, arrivals, vc)
            wall = time.perf_counter() - t0
            rep = LoadReport.from_tickets(tickets, sched.stats)
            what = f"serving {label} at {load}x"
            check(rep.n_expired_dispatched == 0,
                  f"{what}: {rep.n_expired_dispatched} expired requests "
                  f"dispatched")
            # no fault is armed: a retry, a failover or a failed ticket
            # means the engine raised and the host rung answered instead
            st = sched.stats
            check(rep.n_completed > 0 and rep.n_failed == 0
                  and st.n_retries == 0 and st.n_failovers == 0,
                  f"{what}: completed {rep.n_completed}, failed "
                  f"{rep.n_failed}, retries {st.n_retries}, failovers "
                  f"{st.n_failovers} with no fault armed")
            done = [(t, s0) for t, s0 in zip(tickets, starts) if t.done]
            exact = [(t, s0) for t, s0 in done if not t.degraded]
            check(load != 0.8 or bool(exact),
                  f"{what}: no exact ticket below saturation")
            check(all(np.array_equal(t.distances, ref_d[s0:s0 + SERVE_ROWS])
                      for t, s0 in exact),
                  f"{what}: an exact ticket's distances differ from phase 4's")
            degraded = [(t, s0) for t, s0 in done if t.degraded]
            check(load != 2.0 or bool(degraded),
                  f"{what}: no degraded ticket at twice saturation")
            if degraded:
                rows = np.concatenate([r_np[s0:s0 + SERVE_ROWS]
                                       for _, s0 in degraded])
                bd, _ = rt.brute_force_knn(rows, s_np, k, device=DEV)
                got = np.concatenate([t.distances for t, _ in degraded])
                bound = np.concatenate([t.recall_bound for t, _ in degraded])
                true = (got <= bd[:, -1:]).sum(axis=1) / k
                check(bool((true >= bound).all()),
                      f"{what}: a certified recall bound exceeds the true "
                      f"recall against the float64 brute force")
                tightness = float((true - bound).mean())
            else:
                tightness = 0.0
            row = dataclasses.asdict(rep)
            row.update(service_ms=svc * 1e3, saturation_req_s=sat,
                       offered_req_s=rate, wall_s=wall,
                       n_dispatches=sched.stats.n_dispatches,
                       mean_true_minus_bound=tightness)
            out[f"{label}@{load}x"] = row
            print(f"[{card}] {what} ({len(arrivals)} requests of "
                  f"{SERVE_ROWS} rows, offered {rate:.1f} req/s, saturation "
                  f"{sat:.1f} req/s from a {scfg.batch_rows}-row batch of "
                  f"{svc * 1e3:.3f} ms; {wall:.3f} s wall): "
                  + ", ".join(f"{key} {val}" for key, val in
                              dataclasses.asdict(rep).items())
                  + f"; {len(exact)} exact tickets bitwise phase 4, "
                  f"{len(degraded)} degraded with sound bounds (true recall "
                  f"- bound, mean {tightness:.4f})", flush=True)
    counts = launches["serving_load"] = end_path(ops)
    check(counts["quant_coarse_gather"] > 0,
          f"serving: the load runs never launched K-Q: {counts}")
    print(f"[{card}] serving under load: launches {counts}; phase 17 took "
          f"{time.perf_counter() - t_phase:.3f} s", flush=True)
    return out


MESH_SHARDS = (2, 4, 8)     # phase 18: simulated shards of the fp32 megastep
MESH_P1_SHARDS = 8          # phase 18: shards of distributed_phase1
MESH_STORE_STEPS = 16       # phase 18: retrieval steps of the sharded store


def mesh_of(n: int, name: str = "shard"):
    """A mesh of ``n`` shards simulated on the one card (the explicit
    device list is what allows more shards than cards)."""
    from repro_torch.distributed import make_mesh
    return make_mesh((n,), (name,), devices=[DEV] * n)


def true_recall(torch, keys64, kn64, queries, ids, k: int):
    """Per-query recall of ``ids`` against the float64 brute force."""
    import numpy as np
    q = torch.as_tensor(queries, device=DEV).double()
    d2 = torch.clamp((q * q).sum(1)[:, None] + kn64[None, :]
                     - 2.0 * (q @ keys64.T), min=0.0)
    true = torch.topk(d2, k, dim=1, largest=False).indices.cpu().numpy()
    return np.array([len(set(a.tolist()) & set(b.tolist())) / k
                     for a, b in zip(ids, true)])


def osm_rerun_at_scale(card, torch, rt, cfg) -> dict:
    """C15's exact re-run at Forest's scale: the single-device megastep
    self-join of ``N_ROWS`` OSM-like rows at phase 4's config, the share
    of its queries whose K-G run was not certified, the wall time of
    their re-run (``megastep.rerun_scheduled``, over each query's
    scheduled tiles), and a ``C15_SAMPLE``-query sample bitwise the
    float64 oracle over every row."""
    import numpy as np
    from repro_torch.core import megastep
    x = rt.osm_like(N_ROWS, seed=17)
    idx = rt.build_index(x, cfg, device=DEV)
    rerun = megastep.rerun_scheduled
    spent = []

    def timed(*args, **kw):
        t = time.perf_counter()
        got = rerun(*args, **kw)
        torch.cuda.synchronize()
        spent.append(time.perf_counter() - t)
        return got

    megastep.rerun_scheduled = timed
    try:
        t0 = time.perf_counter()
        res = rt.knn_join_batched(x, index=idx, batch_size=BUCKET,
                                  megastep=True, device=DEV)
        wall = time.perf_counter() - t0
    finally:
        megastep.rerun_scheduled = rerun
    sample = np.random.default_rng(17).choice(N_ROWS, C15_SAMPLE,
                                              replace=False)
    bd, _ = rt.brute_force_knn(x[sample], x, cfg.k, device=DEV)
    miss = int((res.distances[sample] != bd).any(1).sum())
    check(miss == 0, f"C15 at {N_ROWS} OSM-like rows: {miss} of "
          f"{C15_SAMPLE} sampled queries miss a neighbour")
    n_re = res.stats.n_exact_rerun
    print(f"[{card}] mesh: OSM-like self-join at {N_ROWS} rows (C15, "
          f"phase 4's config, single device): wall {wall:.3f} s, exact "
          f"re-runs {n_re} ({n_re / N_ROWS:.4f} of the queries) in "
          f"{sum(spent):.3f} s over {len(spent)} batches; {C15_SAMPLE} "
          f"sampled queries bitwise the float64 oracle", flush=True)
    return dict(rows=N_ROWS, wall_s=wall, reruns=n_re,
                rerun_share=n_re / N_ROWS, rerun_s=sum(spent), misses=miss)


def phase_mesh(card, torch, rt, launches, *, s_np, r_np, cfg, idx, res,
               idx_q, cfg_q, res_q, pivots, paper) -> dict:
    """18. The mesh, every shard simulated on the one card from an
    explicit device list: the sharded fp32 megastep over Forest (n = 2,
    4, 8; K-G n × batches; bitwise phase 4) and one steady-state sharded
    ``join_batch_device`` and ``dispatch`` under the sync debug mode; the
    sharded int8 tier (n = 4; bitwise phase 8); the sharded kNN-LM
    datastore over phase 14's keys (r = 2: failover and
    ``recover_shards`` bitwise; r = 1 with a shard lost: certified recall
    bounds at most the true recall, through ``join_batch_covered`` and
    the scheduler's coverage rung); ``distributed_phase1`` on 8 shards
    (the bits of ``assign_and_summarize``, K-A 8 times); the shuffle join
    at ``_three_way``'s settings (9 shards) in L2, L1 and L∞ against the
    float64 oracle; the OSM-like rows' misses of the sharded and the
    single-device megastep (C15); ``launch.join --distributed``."""
    import os
    import numpy as np
    from repro_torch.core.distributed import (distributed_knn_join,
                                              distributed_phase1)
    from repro_torch.core.partition import assign_and_summarize
    from repro_torch.core.sharded import ShardedMegastepEngine
    from repro_torch.kernels import ops
    from repro_torch.serve import Datastore
    from repro_torch.serve.faultinject import FaultPlan, ShardFault
    from repro_torch.serve.scheduler import SchedulerConfig, ServeScheduler
    t_phase = time.perf_counter()
    out = {}

    # ---- the sharded fp32 megastep over all of R
    for n in MESH_SHARDS:
        mesh = mesh_of(n)
        path = f"mesh_fp32_{n}"
        begin_path(ops, path)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = rt.knn_join_batched(r_np, index=idx, batch_size=BUCKET,
                                  megastep=True, mesh=mesh, device=DEV)
        wall = time.perf_counter() - t0
        counts = launches[path] = end_path(ops)
        batches = got.stats.n_batches
        check(counts["distance_topk_gather"] == n * batches,
              f"sharded megastep n={n}: K-G launched "
              f"{counts['distance_topk_gather']} times, expected {n} x "
              f"{batches}")
        check_same_distances(f"sharded megastep n={n} vs phase 4",
                             got.distances, res.distances, got.indices,
                             res.indices, r_np, s_np)
        # C17: the ids too, on every slot (ties included)
        off = int((got.indices != res.indices).sum())
        check(off == 0, f"sharded megastep n={n}: {off} ids differ from "
                        f"phase 4's")
        per = idx.shard_packing(n, cfg.tile_s).nbytes_per_shard()
        out[path] = dict(wall_s=wall, queries_s=N_ROWS / wall,
                         nbytes_per_shard=per.tolist(), launches=counts,
                         exact_reruns=got.stats.n_exact_rerun)
        print(f"[{card}] mesh: sharded megastep n={n} over {N_ROWS} "
              f"queries: {wall:.3f} s = {N_ROWS / wall:.1f} queries/s "
              f"(build included), {batches} batches, K-G {n} x {batches}; "
              f"bitwise phase 4's distances and ids (every slot); exact "
              f"re-runs (C15) {got.stats.n_exact_rerun}; bytes per shard "
              f"{per.tolist()}; launches {counts}", flush=True)
    eng = ShardedMegastepEngine(idx, cfg, mesh=mesh_of(4))
    qd, nv = eng.enqueue(r_np[:BUCKET])
    warm = eng.join_batch_device(qd, nv)
    h0 = eng.dispatch(r_np[:BUCKET])
    eng.finalize(h0)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        step = eng.join_batch_device(qd, nv)
        h = eng.dispatch(r_np[:BUCKET])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    d_h, i_h = eng.finalize(h)
    check(all(torch.equal(a, b) for a, b in zip(step, warm)),
          "sharded steady state: repeated step differs")
    check(np.array_equal(d_h, res.distances[:BUCKET]),
          "sharded dispatch: distances differ from phase 4's")
    step_ms = time_ms(lambda: eng.join_batch_device(qd, nv), iters=10)
    out["mesh_step_ms_n4"] = step_ms
    print(f"[{card}] mesh: steady-state sharded join_batch_device and "
          f"dispatch (n=4): no host sync under set_sync_debug_mode('error');"
          f" {step_ms:.4f} ms per {BUCKET}-query step", flush=True)
    del eng, warm, step

    # ---- the sharded int8 tier
    begin_path(ops, "mesh_quant_4")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = rt.knn_join_batched(r_np, index=idx_q, batch_size=BUCKET,
                              quantized=True, mesh=mesh_of(4),
                              device=DEV)
    wall = time.perf_counter() - t0
    counts = launches["mesh_quant_4"] = end_path(ops)
    st = got.stats
    check(counts["quant_coarse_gather"] > 0 and st.quant_mode == "int8",
          f"sharded int8 tier: K-Q never launched: {counts}")
    check_same_distances("sharded int8 tier n=4 vs phase 8",
                         got.distances, res_q.distances, got.indices,
                         res_q.indices, r_np, s_np)
    out["mesh_quant_4"] = dict(wall_s=wall, fallback=st.n_quant_fallback,
                               launches=counts)
    print(f"[{card}] mesh: sharded int8 tier n=4 over {N_ROWS} queries: "
          f"{wall:.3f} s = {N_ROWS / wall:.1f} queries/s, certification "
          f"fallbacks {st.n_quant_fallback} ({st.n_quant_fallback / N_ROWS:.4%})"
          f"; bitwise phase 8's distances; launches {counts}", flush=True)

    # ---- the sharded datastore at the LM scale (phase 14's keys)
    rng = np.random.default_rng(14)
    keys = rng.standard_normal((LM_STORE_KEYS, LM_STORE_DIM),
                               dtype=np.float32)
    vals = rng.integers(0, 128_256, LM_STORE_KEYS).astype(np.int32)
    qs = np.random.default_rng(18).standard_normal(
        (MESH_STORE_STEPS, BUCKET, LM_STORE_DIM), dtype=np.float32)
    kw = dict(k=8, n_pivots=128, n_groups=8, device=DEV)
    single = Datastore.build(keys, vals, **kw)
    ref = [single.retrieve(q)[:2] for q in qs]
    del single
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    store = Datastore.build(keys, vals, n_shards=4, replication=2,
                            mesh=mesh_of(4), **kw)
    got = [store.retrieve(q)[:2] for q in qs]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for i, ((d, ids), (rd, ri)) in enumerate(zip(got, ref)):
        check_same_distances(f"sharded store step {i}", d, rd, ids, ri,
                             qs[i], keys)
    keys64 = torch.as_tensor(keys, device=DEV).double()
    kn64 = (keys64 * keys64).sum(1)
    check_retrieval(card, torch, "sharded store step 0", qs[0][:512],
                    keys64, kn64, got[0][0][:512], got[0][1][:512], 8)
    me = store.engine().megastep_engine
    with FaultPlan().fail("sharded.shard_compute", times=1, exc=ShardFault(
            "sharded.shard_compute", shard=1)) as plan:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        d, ids, _ = store.retrieve(qs[0])
        failover_ms = (time.perf_counter() - t0) * 1e3
    n_seg = len(me._index_parts()[0])
    uploads = plan.fired.get("sharded.shard_upload", 0)
    check(me.health.failed == frozenset({1}) and not me.coverage_degraded,
          f"sharded store failover: health {me.health.failed}")
    check(np.array_equal(d, got[0][0]) and np.array_equal(ids, got[0][1]),
          "sharded store: failover (r = 2) changed the bits")
    check(uploads == 4 * (1 + n_seg),
          f"sharded store failover re-uploaded {uploads} pieces, expected "
          f"the masks only: 4 x (1 alive + {n_seg} present)")
    t0 = time.perf_counter()
    store.recover_shards(wait=True)
    recover_s = time.perf_counter() - t0
    d, ids, _ = store.retrieve(qs[0])
    check(not me.health.failed and np.array_equal(d, got[0][0])
          and np.array_equal(ids, got[0][1]),
          "sharded store: recover_shards changed the bits")
    print(f"[{card}] mesh: sharded Datastore ({LM_STORE_KEYS} keys x "
          f"{LM_STORE_DIM}, 4 shards, r=2): build + {MESH_STORE_STEPS} steps "
          f"of {BUCKET} queries {wall:.3f} s, every step bitwise the "
          f"single-device store; failover of shard 1 {failover_ms:.3f} ms "
          f"(bitwise; {uploads} mask pieces re-uploaded, no rows); "
          f"recover_shards {recover_s:.3f} s (bitwise)", flush=True)
    out["mesh_store"] = dict(wall_s=wall, failover_ms=failover_ms,
                             recover_s=recover_s, mask_uploads=uploads)
    del store, got, ref, me
    # r = 1 with one shard lost: certified degraded coverage
    store = Datastore.build(keys, vals, n_shards=4, replication=1,
                            mesh=mesh_of(4), **kw)
    me = store.engine().megastep_engine
    qc = np.random.default_rng(19).standard_normal(
        (2, 1024, LM_STORE_DIM), dtype=np.float32)
    store.retrieve(qc[0][:16])
    q = qc[0]
    with FaultPlan().fail("sharded.shard_compute", times=1, exc=ShardFault(
            "sharded.shard_compute", shard=2)):
        d, ids, rb = me.join_batch_covered(q)
    rec = true_recall(torch, keys64, kn64, q, ids, 8)
    check(me.coverage_degraded and bool((rb <= rec + 1e-6).all()),
          f"r=1 covered join: a certified recall bound exceeds the true "
          f"recall ({int((rb > rec + 1e-6).sum())} queries)")
    sched = ServeScheduler.for_datastore(store, config=SchedulerConfig(
        batch_rows=1024, max_inflight=1))
    tk = sched.join_now(qc[1])
    rec2 = true_recall(torch, keys64, kn64, qc[1], tk.indices, 8)
    check(tk.done and tk.degraded and tk.recall_bound is not None
          and bool((tk.recall_bound <= rec2 + 1e-6).all()),
          "the scheduler's coverage rung: degraded ticket without a sound "
          "recall bound")
    print(f"[{card}] mesh: r=1 with shard 2 lost: coverage "
          f"{me.coverage_fraction():.4f}; join_batch_covered rb mean "
          f"{float(rb.mean()):.4f} min {float(rb.min()):.4f} <= true recall "
          f"(mean {float(rec.mean()):.4f}); the scheduler's coverage rung "
          f"rb mean {float(tk.recall_bound.mean()):.4f} <= true recall "
          f"(mean {float(rec2.mean()):.4f})", flush=True)
    out["mesh_covered"] = dict(coverage=me.coverage_fraction(),
                               rb_mean=float(rb.mean()),
                               recall_mean=float(rec.mean()))
    del store, me, keys64, kn64, keys
    torch.cuda.empty_cache()

    # ---- phase 1 over 8 shards: assign_and_summarize's bits
    s_dev = torch.as_tensor(s_np, device=DEV)
    p0, d0, t0_ = assign_and_summarize(s_dev, pivots, k=cfg.k)
    begin_path(ops, "mesh_phase1")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p1, d1, t1 = distributed_phase1(s_np, pivots,
                                    mesh_of(MESH_P1_SHARDS, "data"),
                                    k=cfg.k)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launches["mesh_phase1"] = end_path(ops)
    check(counts["assign"] == MESH_P1_SHARDS,
          f"distributed_phase1: K-A launched {counts['assign']} times, "
          f"expected {MESH_P1_SHARDS}")
    check(torch.equal(p0, p1) and torch.equal(d0, d1) and all(
        torch.equal(getattr(t0_, f), getattr(t1, f))
        for f in ("counts", "lower", "upper", "knn_dists")),
        "distributed_phase1: not the bits of assign_and_summarize")
    out["mesh_phase1"] = dict(wall_s=wall, launches=counts)
    print(f"[{card}] mesh: distributed_phase1 over {N_ROWS} rows on "
          f"{MESH_P1_SHARDS} shards: {wall:.3f} s, the bits of "
          f"assign_and_summarize; launches {counts}", flush=True)
    del s_dev

    # ---- the shuffle join at _three_way's settings (9 shards)
    x = rt.forest_like(PAPER_ROWS, DIM, seed=16)
    mesh9 = mesh_of(PAPER_REDUCERS, "data")
    for metric in ("l2", "l1", "linf"):
        bd, bi = rt.brute_force_knn(x, x, PAPER_K, metric=metric, device=DEV)
        pcfg = rt.JoinConfig(k=PAPER_K, n_pivots=PAPER_PIVOTS,
                             n_groups=PAPER_REDUCERS, metric=metric)
        path = f"mesh_shuffle_{metric}"
        begin_path(ops, path)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plan = rt.core.plan_join(x, x, pcfg, device=DEV)
        got = distributed_knn_join(x, x, plan, mesh9, reducer="shuffle")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launches[path] = end_path(ops)
        same = check_oracle(f"shuffle join ({metric})", x, x, got.distances,
                            got.indices, bd, bi, metric)
        if metric == "l2":
            check(counts["distance_topk"] > 0,
                  f"L2 shuffle join did not run K-D: {counts}")
        st = got.stats
        pg = paper.get("paper_pgbj_forest", {}).get("wall_s")
        out[path] = dict(wall_s=wall, shuffle_tuples=st.shuffle_tuples,
                         alpha=st.replicas_s / st.n_s, launches=counts)
        print(f"[{card}] mesh: shuffle join ({metric}, {PAPER_ROWS} "
              f"Forest-like rows, k {PAPER_K}, {PAPER_REDUCERS} shards, "
              f"{PAPER_PIVOTS} pivots): wall {wall:.3f} s with planning "
              f"(phase 16's PGBJ {pg if pg is None else f'{pg:.3f}'} s), "
              f"shuffle_tuples {st.shuffle_tuples}, alpha "
              f"{st.replicas_s / st.n_s:.4f}; bitwise the float64 oracle, "
              f"ids equal {same:.6f}; launches {counts}", flush=True)

    # ---- C15: OSM-like rows exact, sharded and single-device
    x = rt.osm_like(PAPER_ROWS, seed=16)
    bd, _ = rt.brute_force_knn(x, x, PAPER_K, device=DEV)
    ocfg = rt.JoinConfig(k=PAPER_K, n_pivots=PAPER_PIVOTS)
    oidx = rt.build_index(x, ocfg, device=DEV)
    t0 = time.perf_counter()
    one = rt.knn_join_batched(x, index=oidx, batch_size=BUCKET,
                              megastep=True, device=DEV)
    t_one = time.perf_counter() - t0
    t0 = time.perf_counter()
    sh = rt.knn_join_batched(x, index=oidx, batch_size=BUCKET,
                             megastep=True, mesh=mesh_of(4), device=DEV)
    t_sh = time.perf_counter() - t0
    miss1 = int((one.distances != bd).any(1).sum())
    miss4 = int((sh.distances != bd).any(1).sum())
    check(miss1 == 0 and miss4 == 0,
          f"C15 on OSM-like rows: single-device megastep misses {miss1} "
          f"rows, the sharded one {miss4}")
    check(np.array_equal(one.indices, sh.indices),
          "C15/C17 on OSM-like rows: sharded ids differ from one device's")
    out["mesh_c15"] = dict(single=miss1, sharded=miss4,
                           reruns_single=one.stats.n_exact_rerun,
                           reruns_sharded=sh.stats.n_exact_rerun,
                           wall_single_s=t_one, wall_sharded_s=t_sh)
    print(f"[{card}] mesh: OSM-like self-join ({PAPER_ROWS} rows, C15): "
          f"rows missing a neighbour vs the float64 oracle: single-device "
          f"megastep {miss1} ({t_one:.3f} s), sharded (n=4) {miss4} "
          f"({t_sh:.3f} s), ids equal; exact re-runs of uncertified K-G runs "
          f"{one.stats.n_exact_rerun} / {sh.stats.n_exact_rerun} "
          f"({one.stats.n_exact_rerun / PAPER_ROWS:.4f} of the queries)",
          flush=True)
    out["mesh_c15_large"] = osm_rerun_at_scale(card, torch, rt, cfg)

    # ---- the launcher
    cmd = [sys.executable, "-m", "repro_torch.launch.join", "--n",
           str(N_ROWS), "--distributed", "--shards", "4", "--simulate",
           "--verify"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                          env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    wall = time.perf_counter() - t0
    check(proc.returncode == 0 and "verified vs brute force on 500 "
          "samples: True" in proc.stdout,
          f"launch.join --distributed failed: {proc.stdout[-2000:]}"
          f"{proc.stderr[-2000:]}")
    out["mesh_launch_s"] = wall
    print(f"[{card}] mesh: {' '.join(cmd[1:])}: {wall:.3f} s; "
          + " | ".join(proc.stdout.strip().splitlines()), flush=True)
    print(f"[{card}] phase 18 (the mesh) took "
          f"{time.perf_counter() - t_phase:.3f} s", flush=True)
    return out


MOE_ARCH = "deepseek-v2-lite-16b"   # phase 19: MoE + MLA, full width and depth
# phase 14's 16 requests x 32 tokens, cut to one wave of 8 x 16
MOE_REQUESTS, MOE_BATCH, MOE_NEW = 8, 8, 16
# arctic-480b at full width, its 35 layers cut to 2 (27.3e9 parameters)
ARCTIC_LAYERS, ARCTIC_BATCH, ARCTIC_PROMPT, ARCTIC_NEW = 2, 4, 512, 8


def moe_drops(log, n_moe: int, blocks: int) -> list:
    """Per MoE layer, the dropped share of routed (token, choice) pairs of
    ``blocks`` consecutive blocks a layer (the MoE's ``drop_log``)."""
    out = []
    for j in range(n_moe):
        part = log[j * blocks:(j + 1) * blocks]
        kept, routed = sum(a for a, _ in part), sum(b for _, b in part)
        out.append(1.0 - kept / routed)
    return out


def attention_err_terms(torch, out, ref, terms) -> tuple:
    """K-F's bf16 output against its plain version's where an output may
    cancel to near 0 (MLA's latent, a mean of O(1) values): both sum in
    float32 in another order, so they agree within one bf16 rounding of
    the larger output plus 2⁻¹⁴ of ``terms`` = Σ p·|v| (the plain version
    over |v|), the scale of what was summed. Returns (max |err|, the share
    of this limit used, the share of ``attention_err``'s limit used, and
    |out|, |ref|, terms at the element farthest past the latter)."""
    a, b = out.float(), ref.float()
    diff = (a - b).abs()
    big = torch.maximum(a.abs(), b.abs())
    old = diff / (2.0 ** -7 * big + 1e-6)
    lim = 2.0 ** -7 * big + 2.0 ** -14 * terms.float() + 1e-6
    j = int(torch.argmax(old))
    return (float(diff.max()), float((diff / lim).max()),
            float(old.flatten()[j]), float(a.abs().flatten()[j]),
            float(b.abs().flatten()[j]), float(terms.flatten()[j]))


def layer_check(card, torch, cfg, params, opts, pad, what: str, *,
                calls=None, extra=None) -> float:
    """Every layer's K-F output of one prefill of ``pad`` and one decode
    step against the plain version on the same inputs (the limit of
    ``attention_err_terms``); returns the worst share of the limit.
    ``calls`` is the K-F calls the two steps make (default two a layer);
    ``extra()``, run under the check, gives the steps' keyword arguments
    (whisper's ``enc_out``, its encoder's calls checked too)."""
    from repro_torch.kernels import flash_attention as kf
    from repro_torch.kernels import ops
    from repro_torch.models import init_cache
    from repro_torch.serve import ServeConfig, make_serve_step
    errs = []
    flash = ops.flash_attention

    def checking(q, k, v, **kw):
        out = flash(q, k, v, **kw)
        errs.append(attention_err_terms(
            torch, out, kf.flash_attention_plain(q, k, v, **kw),
            kf.flash_attention_plain(q, k, v.abs(), **kw)))
        return out

    prefill_step, decode_step = make_serve_step(cfg, ServeConfig(), opts)
    ops.flash_attention = checking
    try:
        kw = {} if extra is None else extra()
        cache = init_cache(cfg, pad.shape[0], pad.shape[1] + 2, opts,
                           device=DEV)
        logits, cache = prefill_step(params, torch.as_tensor(pad, device=DEV),
                                     cache, **kw)
        tok = torch.argmax(logits, -1).to(torch.int32)
        decode_step(params, tok[:, None], cache, **kw)
    finally:
        ops.flash_attention = flash
    torch.cuda.synchronize()
    want = 2 * cfg.n_layers if calls is None else calls
    check(len(errs) == want,
          f"{what} layer check: {len(errs)} K-F calls, expected {want}")
    worst = max(e[1] for e in errs)
    j = max(range(len(errs)), key=lambda i: errs[i][2])
    far = errs[j]
    print(f"[{card}] {what} layer check: all {len(errs)} K-F calls "
          f"of one prefill (b={pad.shape[0]}, {pad.shape[1]} tokens) "
          f"and one decode step vs the plain version on the same inputs: max "
          f"|err| {max(e[0] for e in errs):.3e}, {worst:.3f} of the limit "
          f"(one bf16 rounding + 2^-14 of sum p|v|); against one bf16 "
          f"rounding alone at most {far[2]:.3f} (call {j} of {len(errs)}: "
          f"|out| {far[3]:.3e}, |plain| {far[4]:.3e}, sum p|v| "
          f"{far[5]:.3e})", flush=True)
    check(worst <= 1.0, f"{what} layer check: a layer's K-F output is "
          f"{worst:.3f} of the limit off its plain version")
    return worst


def reduced_family(card, torch, arch, rng, *, cfg=None) -> dict:
    """The reduced config on the card and on the CPU with the same weights
    (fp32): logits of a 4 × 300-token forward within 2e-5 + 2e-5·|logit|,
    greedy tokens of 5 requests through the decode cache equal
    (``BatchedServer`` at batch 2; whisper through ``make_serve_step``
    with ``enc_out``). ``cfg`` replaces the reduced config (phase 22: a
    logit softcap)."""
    import numpy as np
    from repro_torch import configs
    from repro_torch.models import (ModelOptions, count_params, encode,
                                    forward, init_cache, init_params)
    from repro_torch.serve import BatchedServer, ServeConfig, make_serve_step
    cfg = configs.get_reduced(arch) if cfg is None else cfg
    opts = ModelOptions(dtype=torch.float32)
    cpu_params = init_params(cfg, torch.Generator().manual_seed(2), opts,
                             device="cpu")

    dev_params = to_device(cpu_params)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (4, 300)))
    ex = {}
    if cfg.n_enc_layers:
        ex["enc_frames"] = torch.as_tensor(rng.standard_normal(
            (4, cfg.enc_len, cfg.d_model), dtype=np.float32))
    lg_cpu, _ = forward(cpu_params, cfg, toks, opts=opts, **ex)
    lg_dev, _ = forward(dev_params, cfg, toks.to(DEV), opts=opts,
                        **{key: val.to(DEV) for key, val in ex.items()})
    lg_dev = lg_dev.cpu()
    diff = float((lg_dev - lg_cpu).abs().max())
    check(bool(((lg_dev - lg_cpu).abs() <= 2e-5 + 2e-5 * lg_cpu.abs()).all()),
          f"reduced {arch}: card logits off the CPU's by {diff:.3e}, past "
          f"2e-5 + 2e-5·|logit|")
    small = [rng.integers(0, cfg.vocab, int(m)).astype(np.int32)
             for m in (5, 130, 3, 260, 40)]
    got = {}
    for where, p, dev in (("cpu", cpu_params, "cpu"),
                          ("card", dev_params, DEV)):
        if not cfg.n_enc_layers:
            got[where] = BatchedServer(cfg, ServeConfig(batch=2), p,
                                       opts).generate(small, max_new_tokens=8)
            continue
        prefill_step, decode_step = make_serve_step(cfg, ServeConfig(), opts)
        tmax = max(map(len, small))
        pad = np.zeros((len(small), tmax), np.int64)
        for r, s in enumerate(small):
            pad[r, tmax - len(s):] = s
        enc = encode(p, cfg, ex["enc_frames"][:1].expand(
            len(small), -1, -1).to(dev), opts)
        cache = init_cache(cfg, len(small), tmax + 8, opts, device=dev)
        logits, cache = prefill_step(p, torch.as_tensor(pad, device=dev),
                                     cache, enc_out=enc)
        out = []
        for _ in range(8):
            tok = torch.argmax(logits, -1).to(torch.int32)
            out.append(tok.cpu().numpy())
            logits, cache = decode_step(p, tok[:, None], cache, enc_out=enc)
        got[where] = list(np.stack(out, 1))
    check(all(np.array_equal(a, b) for a, b in zip(got["cpu"], got["card"])),
          f"reduced {arch}: greedy tokens differ between card and CPU")
    print(f"[{card}] reduced {arch}"
          + (f" with cap {cfg.attn_logit_softcap:g}"
             if cfg.attn_logit_softcap else "")
          + f" (fp32, {count_params(cpu_params)} parameters): card vs CPU logits over 4 x 300 tokens max |diff| "
          f"{diff:.3e} (limit 2e-5 + 2e-5·|logit|); greedy tokens of 5 "
          f"requests (batch 2, 8 tokens, through the decode cache) equal",
          flush=True)
    return dict(max_abs_logit_diff=diff)


def phase_moe(card, torch, rt, launches) -> tuple:
    """19. The MoE family on the card: MLA on K-F and the MoE FFN. (a) K-F
    vs its plain version at MLA's shapes — absorbed decode and prefill
    (MQA, d = kv_lora + rope = 576, v = k) and the expanded prefill (d =
    192, v zero-padded from 128) — with SDPA timed beside each; (b)
    deepseek-v2-lite-16b at full width and depth (27 layers, bf16, seeded
    weights) through ``BatchedServer`` + ``make_knn_hook`` over phase 14's
    1,048,576 × 32 keys: 8 requests of 512-2,048 tokens, batch 8, 16
    greedy tokens, counted (K-F 27 times a forward), every retrieval exact,
    every layer's K-F output of one prefill and one decode step against
    the plain version, the MoE's dropped share per layer; (c) arctic-480b
    at full width with its depth cut to 2 layers: one prefill and 8 decode
    steps at batch 4, counted, the layer check; (d) the reduced deepseek
    and arctic on the card and on the CPU with the same weights: logits
    within 2e-5 + 2e-5·|logit|, greedy tokens equal. Returns (K-F's cases,
    the phase's numbers)."""
    import numpy as np
    import torch.nn.functional as F
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.models import (ModelOptions, count_params, init_params,
                                    moe)
    from repro_torch.serve import (BatchedServer, Datastore, KnnLMConfig,
                                   ServeConfig, make_knn_hook)
    t_phase = time.perf_counter()
    out = {}
    cfg = configs.get_arch(MOE_ARCH)
    c = cfg.mla
    h, lat, rope = cfg.n_heads, c.kv_lora_rank, c.rope_head_dim
    dq = c.qk_nope_head_dim + rope
    scale = dq ** -0.5

    # ---- (a) K-F at MLA's shapes
    gen = torch.Generator(device=DEV).manual_seed(19)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=DEV).to(torch.bfloat16)

    def sdpa(q, k, v, **kw):
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        return lambda: F.scaled_dot_product_attention(
            qt, kt, vt, scale=scale, enable_gqa=True, **kw)

    n = LM_PROMPT[1]
    nk = n + MOE_NEW
    q, kv = rand(MOE_BATCH, 1, h, lat + rope), rand(MOE_BATCH, nk, 1,
                                                   lat + rope)
    cases = [attention_case(
        card, torch, f"MLA absorbed decode b={MOE_BATCH} nq=1 nk={nk} "
        f"h={h} kvh=1 d={lat + rope}", q, kv, kv, scale=scale, d_v=lat,
        library=sdpa(q, kv, kv))]
    # the read-only cache's decode (phase 22's A6e): the cache's nk - 1
    # live keys in place and the step's fresh key as K-F's second source
    live, kn = kv[:, :nk - 1], kv[:, nk - 1:].clone()
    cases.append(attention_case(
        card, torch, f"MLA absorbed read-only decode b={MOE_BATCH} nq=1 "
        f"nk={nk - 1}+1 h={h} kvh=1 d={lat + rope}", q, live, live,
        scale=scale, d_v=lat, causal=False, k_new=kn, v_new=kn,
        library=sdpa(q, kv, kv)))
    del live, kn
    q, kv = rand(MOE_BATCH, n, h, lat + rope), rand(MOE_BATCH, n, 1,
                                                   lat + rope)
    cases.append(attention_case(
        card, torch, f"MLA absorbed prefill b={MOE_BATCH} nq=nk={n} h={h} "
        f"kvh=1 d={lat + rope}", q, kv, kv, scale=scale, d_v=lat,
        library=sdpa(q, kv, kv, is_causal=True)))
    del q, kv
    q, k = rand(2, n, h, dq), rand(2, n, h, dq)
    v = F.pad(rand(2, n, h, c.v_head_dim), (0, dq - c.v_head_dim))
    cases.append(attention_case(
        card, torch, f"MLA expanded prefill b=2 nq=nk={n} h={h} d={dq} (v "
        f"padded from {c.v_head_dim})", q, k, v, scale=scale,
        d_v=c.v_head_dim, library=sdpa(q, k, v, is_causal=True)))
    del q, k, v
    torch.cuda.empty_cache()

    # ---- (b) deepseek-v2-lite-16b serving with the kNN-LM hook, counted
    opts = ModelOptions(dtype=torch.bfloat16)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=DEV).manual_seed(0),
                         opts, device=DEV)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_params = count_params(params)
    rng = np.random.default_rng(14)          # phase 14's keys
    keys = rng.standard_normal((LM_STORE_KEYS, LM_STORE_DIM),
                               dtype=np.float32)
    vals = rng.integers(0, cfg.vocab, LM_STORE_KEYS).astype(np.int32)
    rng = np.random.default_rng(19)
    prompts = [rng.integers(0, cfg.vocab, int(rng.integers(
        LM_PROMPT[0], LM_PROMPT[1] + 1))).astype(np.int32)
        for _ in range(MOE_REQUESTS)]
    kcfg = KnnLMConfig(lam=0.2, tau=50.0, k=8)
    begin_path(ops, "moe_serve")
    store = Datastore.build(keys, vals, k=8, n_pivots=128, n_groups=8,
                            device=DEV)
    retrieved = []
    retrieve = record_retrievals(store, retrieved)
    prefill_ms, decode_ms = [], []
    srv = BatchedServer(cfg, ServeConfig(batch=MOE_BATCH), params, opts,
                        logits_hook=make_knn_hook(store, kcfg, cfg.vocab))
    srv.prefill_step = timed(srv.prefill_step, prefill_ms)
    srv.decode_step = timed(srv.decode_step, decode_ms)
    moe.drop_log = []
    try:
        t0 = time.perf_counter()
        outs = srv.generate(prompts, max_new_tokens=MOE_NEW)
        torch.cuda.synchronize()
        t_gen = time.perf_counter() - t0
        log = moe.drop_log
    finally:
        moe.drop_log = None
    counts = launches["moe_serve"] = end_path(ops)
    peak = torch.cuda.max_memory_allocated()
    want_fa = cfg.n_layers * (MOE_NEW + 1)
    check(counts["flash_attention"] == want_fa,
          f"MoE serving: K-F launched {counts['flash_attention']} times, "
          f"expected {cfg.n_layers} layers x {MOE_NEW + 1} forwards = "
          f"{want_fa}")
    check(counts["distance_topk_gather"] >= MOE_NEW and counts["assign"] > 0,
          f"MoE serving: K-G must launch once a decode step at least and K-A "
          f"in the Datastore build: {counts}")
    check(len(outs) == MOE_REQUESTS and all(
        o.shape == (MOE_NEW,) and ((o >= 0) & (o < cfg.vocab)).all()
        for o in outs), "MoE serving: malformed generations")
    check(len(retrieved) == MOE_NEW,
          f"MoE serving: {len(retrieved)} retrievals for {MOE_NEW} steps")
    keys64 = torch.as_tensor(keys, device=DEV).double()
    kn64 = (keys64 * keys64).sum(1)
    for i, (qr, d, ids) in enumerate(retrieved):
        check_retrieval(card, torch, f"MoE decode step {i} retrieval", qr,
                        keys64, kn64, d, ids, kcfg.k)
    del keys64, kn64
    tmax = max(len(p) for p in prompts)
    n_tok = MOE_BATCH * tmax
    chunks = n_tok // 4096 if n_tok > 4096 and n_tok % 4096 == 0 else 1
    n_moe = cfg.n_layers - cfg.moe.first_dense
    check(len(log) == n_moe * (chunks + MOE_NEW),
          f"MoE serving: {len(log)} routed blocks, expected {n_moe} x "
          f"({chunks} + {MOE_NEW})")
    drop_pre = moe_drops(log, n_moe, chunks)
    drop_dec = [float(np.mean(x)) for x in zip(*(
        moe_drops(log[n_moe * (chunks + j):], n_moe, 1)
        for j in range(MOE_NEW)))]
    tps = MOE_REQUESTS * MOE_NEW / t_gen
    mo = cfg.moe
    dec_cap = max(1, int(mo.top_k * MOE_BATCH * mo.capacity_factor
                         / mo.n_experts))
    print(f"[{card}] MoE serving {MOE_ARCH} (bf16, {n_params} parameters, "
          f"{cfg.n_layers} layers, MLA on K-F, init {t_init:.3f} s): "
          f"{MOE_REQUESTS} requests of {min(map(len, prompts))}-{tmax} "
          f"prompt tokens, batch {MOE_BATCH}, {MOE_NEW} greedy tokens each in "
          f"{t_gen:.3f} s = {tps:.1f} tokens/s with the kNN-LM hook over "
          f"{LM_STORE_KEYS} keys; prefill {prefill_ms[0]:.3f} ms; decode ms "
          f"per step median {float(np.median(decode_ms)):.3f}; peak memory "
          f"{peak / 2 ** 30:.3f} GiB; launches {counts}; every retrieval "
          f"({len(retrieved)}) exact vs the float64 brute force", flush=True)
    print(f"[{card}] MoE dropped share per MoE layer (capacity factor "
          f"{cfg.moe.capacity_factor}): prefill ({n_tok} tokens, {chunks} "
          f"routed block(s) a layer) "
          + ", ".join(f"{x:.4f}" for x in drop_pre) + "; decode (batch "
          f"{MOE_BATCH}, cap {dec_cap}; mean over {MOE_NEW} steps) "
          + ", ".join(f"{x:.4f}" for x in drop_dec), flush=True)
    pad = np.zeros((MOE_BATCH, tmax), np.int32)
    for r, p in enumerate(prompts):
        pad[r, tmax - len(p):] = p
    worst = layer_check(card, torch, cfg, params, opts, pad, MOE_ARCH)
    # the read-only cache on MLA (Queue A6e): two prompts cut to 512 tokens
    out["moe_readonly"] = readonly_check(
        card, torch, cfg, params, opts, [x[:512] for x in prompts[:2]],
        MOE_ARCH, "moe_readonly", launches)
    out["moe_serve"] = dict(
        arch=MOE_ARCH, params=n_params, init_s=t_init, tokens_per_s=tps,
        prefill_ms=prefill_ms, decode_ms_median=float(np.median(decode_ms)),
        decode_ms=decode_ms, peak_bytes=peak, launches=counts,
        dropped_prefill=drop_pre, dropped_decode=drop_dec,
        layer_check_worst=worst)
    store.retrieve = retrieve
    del params, srv, store
    torch.cuda.empty_cache()

    # ---- (c) arctic-480b at full width, 2 layers
    cfg_a = dataclasses.replace(configs.get_arch("arctic-480b"),
                                n_layers=ARCTIC_LAYERS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg_a, torch.Generator(device=DEV).manual_seed(0),
                         opts, device=DEV)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_params = count_params(params)
    init_peak = torch.cuda.max_memory_allocated()
    prompts = [rng.integers(0, cfg_a.vocab, ARCTIC_PROMPT).astype(np.int32)
               for _ in range(ARCTIC_BATCH)]
    begin_path(ops, "moe_arctic")
    moe.drop_log = []
    try:
        t0 = time.perf_counter()
        outs = BatchedServer(cfg_a, ServeConfig(batch=ARCTIC_BATCH), params,
                             opts).generate(prompts,
                                            max_new_tokens=ARCTIC_NEW)
        torch.cuda.synchronize()
        t_gen = time.perf_counter() - t0
        log = moe.drop_log
    finally:
        moe.drop_log = None
    counts = launches["moe_arctic"] = end_path(ops)
    peak = torch.cuda.max_memory_allocated()
    want_fa = ARCTIC_LAYERS * (ARCTIC_NEW + 1)
    check(counts["flash_attention"] == want_fa,
          f"arctic: K-F launched {counts['flash_attention']} times, expected "
          f"{want_fa}")
    check(all(o.shape == (ARCTIC_NEW,) and ((o >= 0) & (o < cfg_a.vocab))
              .all() for o in outs), "arctic: malformed generations")
    drop_pre = moe_drops(log, ARCTIC_LAYERS, 1)
    drop_dec = [float(np.mean(x)) for x in zip(*(
        moe_drops(log[ARCTIC_LAYERS * (1 + j):], ARCTIC_LAYERS, 1)
        for j in range(ARCTIC_NEW)))]
    pad = np.stack(prompts)
    worst = layer_check(card, torch, cfg_a, params, opts, pad,
                        "arctic-480b (2 layers)")
    print(f"[{card}] arctic-480b at full width, {ARCTIC_LAYERS} of 35 layers "
          f"(bf16, {n_params} parameters, init {t_init:.3f} s, init peak "
          f"{init_peak / 2 ** 30:.3f} GiB): {ARCTIC_BATCH} requests of "
          f"{ARCTIC_PROMPT} tokens, one prefill and {ARCTIC_NEW} decode "
          f"steps in {t_gen:.3f} s; peak memory {peak / 2 ** 30:.3f} GiB; "
          f"K-F GQA {cfg_a.n_heads}/{cfg_a.n_kv_heads} heads, "
          f"{cfg_a.moe.n_experts} experts top-{cfg_a.moe.top_k} beside the "
          f"dense residual; dropped share prefill "
          + ", ".join(f"{x:.4f}" for x in drop_pre) + ", decode "
          + ", ".join(f"{x:.4f}" for x in drop_dec)
          + f"; launches {counts}", flush=True)
    out["moe_arctic"] = dict(
        params=n_params, init_s=t_init, init_peak_bytes=init_peak,
        wall_s=t_gen, peak_bytes=peak, launches=counts,
        dropped_prefill=drop_pre, dropped_decode=drop_dec,
        layer_check_worst=worst)
    del params
    torch.cuda.empty_cache()

    # ---- (d) the reduced models: card vs CPU, the same weights
    for arch in (MOE_ARCH, "arctic-480b"):
        out[f"reduced_{arch}"] = reduced_family(card, torch, arch, rng)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[{card}] phase 19 (MoE + MLA) {out['phase_s']:.3f} s",
          flush=True)
    return cases, out


# phase 20: the recurrent, hybrid, audio and VLM families at full width
FAMILY_ARCHS = ("recurrentgemma-9b", "xlstm-350m", "qwen2-vl-7b")
FAM_REQUESTS, FAM_BATCH, FAM_NEW = 8, 8, 16   # phase 19's traffic
WHISPER_ARCH = "whisper-small"
WHISPER_PROMPT, WHISPER_NEW = (16, 224), 32


def attention_calls(cfg) -> int:
    """K-F calls of one decoder forward: one per attention layer, two per
    cross-attention layer (none for the recurrent kinds)."""
    from repro_torch.configs.base import ATTN, ATTN_BIDIR, LOCAL, XATTN
    from repro_torch.models import layer_kinds
    return sum({ATTN: 1, ATTN_BIDIR: 1, LOCAL: 1, XATTN: 2}.get(
        kind.replace("_dense", ""), 0) for kind in layer_kinds(cfg))


def family_kf_cases(card, torch) -> list:
    """K-F vs its plain version at the shapes phase 20's families give it,
    SDPA beside each: whisper's encoder (non-causal, 1,500 × 1,500, MHA
    d = 64) and cross-attention (prompt and one query against 1,500);
    recurrentgemma's windowed prefill and ring decode (MQA, d = 256);
    qwen2-vl's prefill (GQA 28 / 4, d = 128)."""
    import torch.nn.functional as F
    from repro_torch import configs
    gen = torch.Generator(device=DEV).manual_seed(20)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=DEV).to(torch.bfloat16)

    def sdpa(q, k, v, **kw):
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        return lambda: F.scaled_dot_product_attention(
            qt, kt, vt, enable_gqa=True, **kw)

    cases = []
    w = configs.get_arch(WHISPER_ARCH)
    b, n, h, d = FAM_BATCH, w.enc_len, w.n_heads, w.dh
    for nq in (n, WHISPER_PROMPT[1], 1):
        q, k, v = rand(b, nq, h, d), rand(b, n, h, d), rand(b, n, h, d)
        what = ("whisper encoder" if nq == n else "whisper cross-attention")
        cases.append(attention_case(
            card, torch, f"{what} b={b} nq={nq} nk={n} h={h} d={d}", q, k, v,
            causal=False, library=sdpa(q, k, v)))
    g = configs.get_arch("recurrentgemma-9b")
    n, h, kvh, d, win = LM_PROMPT[1], g.n_heads, g.n_kv_heads, g.dh, \
        g.local_window
    q, k, v = rand(b, n, h, d), rand(b, n, kvh, d), rand(b, n, kvh, d)
    pos = torch.arange(n, device=DEV)
    wmask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - win)
    cases.append(attention_case(
        card, torch, f"recurrentgemma local prefill b={b} nq=nk={n} h={h} "
        f"kvh={kvh} d={d}", q, k, v, window=win,
        library=sdpa(q, k, v, attn_mask=wmask)))
    del q, wmask
    q = rand(b, 1, h, d)
    cases.append(attention_case(
        card, torch, f"recurrentgemma ring decode b={b} nq=1 nk={n} h={h} "
        f"kvh={kvh} d={d}", q, k, v, causal=False, library=sdpa(q, k, v)))
    del q, k, v
    qw = configs.get_arch("qwen2-vl-7b")
    h, kvh, d = qw.n_heads, qw.n_kv_heads, qw.dh
    q, k, v = rand(b, n, h, d), rand(b, n, kvh, d), rand(b, n, kvh, d)
    cases.append(attention_case(
        card, torch, f"qwen2-vl prefill b={b} nq=nk={n} h={h} kvh={kvh} "
        f"d={d}", q, k, v, library=sdpa(q, k, v, is_causal=True)))
    del q, k, v
    torch.cuda.empty_cache()
    return cases


def serve_family(card, torch, arch, store, keys, kcfg, launches, *,
                 cfg=None, path=None, prompts=None) -> dict:
    """One family at full width and depth, bf16, seeded weights, through
    ``BatchedServer`` + ``make_knn_hook`` over ``store``: phase 19's
    traffic (8 requests of 512-2,048 tokens, the longest exactly 2,048,
    batch 8, 16 greedy tokens), counted; every retrieval exact; the layer
    check. qwen2-vl also runs one prefill and one decode step with 64
    seeded vision embeddings over (t, h, w) positions, counted. ``cfg``
    replaces the arch's config (phase 22: a logit softcap), ``path``
    names the counted path and ``prompts`` replace the traffic's."""
    import numpy as np
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.models import ModelOptions, count_params, init_params
    from repro_torch.serve import BatchedServer, ServeConfig, make_knn_hook
    cfg = configs.get_arch(arch) if cfg is None else cfg
    opts = ModelOptions(dtype=torch.bfloat16)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=DEV).manual_seed(0),
                         opts, device=DEV)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_params = count_params(params)
    if prompts is None:
        rng = np.random.default_rng(20)
        lens = [LM_PROMPT[1]] + [int(rng.integers(LM_PROMPT[0],
                                                  LM_PROMPT[1] + 1))
                                 for _ in range(FAM_REQUESTS - 1)]
        prompts = [rng.integers(0, cfg.vocab, m).astype(np.int32)
                   for m in lens]
    lens = [len(x) for x in prompts]
    prefill_ms, decode_ms = [], []
    srv = BatchedServer(cfg, ServeConfig(batch=FAM_BATCH), params, opts,
                        logits_hook=make_knn_hook(store, kcfg, cfg.vocab))
    srv.prefill_step = timed(srv.prefill_step, prefill_ms)
    srv.decode_step = timed(srv.decode_step, decode_ms)
    name = path or "fam_" + arch.split("-")[0]
    retrieved = []
    retrieve = record_retrievals(store, retrieved)
    begin_path(ops, name)
    try:
        t0 = time.perf_counter()
        outs = srv.generate(prompts, max_new_tokens=FAM_NEW)
        torch.cuda.synchronize()
        t_gen = time.perf_counter() - t0
    finally:
        store.retrieve = retrieve
    counts = launches[name] = end_path(ops)
    peak = torch.cuda.max_memory_allocated()
    waves = -(-FAM_REQUESTS // FAM_BATCH)
    want_fa = attention_calls(cfg) * waves * (FAM_NEW + 1)
    check(counts["flash_attention"] == want_fa,
          f"{arch} serving: K-F launched {counts['flash_attention']} times, "
          f"expected {attention_calls(cfg)} attention layers x {waves} "
          f"waves x {FAM_NEW + 1} forwards = {want_fa}")
    check(counts["distance_topk_gather"] >= waves * FAM_NEW,
          f"{arch} serving: K-G must launch once a decode step at least: "
          f"{counts}")
    check(len(outs) == FAM_REQUESTS and all(
        o.shape == (FAM_NEW,) and ((o >= 0) & (o < cfg.vocab)).all()
        for o in outs), f"{arch} serving: malformed generations")
    check(len(retrieved) == waves * FAM_NEW,
          f"{arch} serving: {len(retrieved)} retrievals for "
          f"{waves * FAM_NEW} decode steps")
    keys64 = torch.as_tensor(keys, device=DEV).double()
    kn64 = (keys64 * keys64).sum(1)
    for i, (qr, d, ids) in enumerate(retrieved):
        check_retrieval(card, torch, f"{arch} decode step {i} retrieval", qr,
                        keys64, kn64, d, ids, kcfg.k)
    del keys64, kn64
    tps = FAM_REQUESTS * FAM_NEW / t_gen
    print(f"[{card}] {arch} serving (bf16, {n_params} parameters, "
          f"{cfg.n_layers} layers, {attention_calls(cfg)} on K-F, init "
          f"{t_init:.3f} s): {FAM_REQUESTS} requests of {min(lens)}-"
          f"{max(lens)} prompt tokens, batch {FAM_BATCH}, {FAM_NEW} greedy "
          f"tokens each in {t_gen:.3f} s = {tps:.1f} tokens/s with the "
          f"kNN-LM hook over {LM_STORE_KEYS} keys; prefill "
          f"{prefill_ms[0]:.3f} ms; decode ms per step median "
          f"{float(np.median(decode_ms)):.3f}; peak memory "
          f"{peak / 2 ** 30:.3f} GiB; launches {counts}; every retrieval "
          f"({len(retrieved)}) exact vs the float64 brute force", flush=True)
    pad = np.zeros((FAM_BATCH, max(lens)), np.int32)    # the first wave
    for r, p in enumerate(prompts[:FAM_BATCH]):
        pad[r, max(lens) - len(p):] = p
    worst = None
    if attention_calls(cfg):
        # the decode step sits at position 2,048: recurrentgemma's ring of
        # 2,048 slots has wrapped
        worst = layer_check(card, torch, cfg, params, opts, pad, arch,
                            calls=2 * attention_calls(cfg))
    else:
        print(f"[{card}] {arch} layer check: no attention layer (K-F "
              f"launched {counts['flash_attention']} times)", flush=True)
    out = dict(arch=arch, params=n_params, init_s=t_init, tokens_per_s=tps,
               prefill_ms=prefill_ms, decode_ms=decode_ms,
               decode_ms_median=float(np.median(decode_ms)),
               peak_bytes=peak, launches=counts, layer_check_worst=worst)
    if cfg.n_vision_embeds:
        out["vision"] = vision_step(card, torch, cfg, params, opts, pad,
                                    launches)
    del params, srv
    torch.cuda.empty_cache()
    return out


def vision_step(card, torch, cfg, params, opts, pad, launches) -> dict:
    """qwen2-vl with its stub vision tower's output: one prefill of
    ``pad`` whose first 64 positions are seeded vision embeddings on an
    8 × 8 (t, h, w) grid, the text after it on one axis from 8 on, and
    one decode step; counted; finite logits that differ from the
    text-only prefill's."""
    from repro_torch.kernels import ops
    from repro_torch.models import init_cache
    from repro_torch.serve import ServeConfig, make_serve_step
    b, t = pad.shape
    nv = cfg.n_vision_embeds
    side = int(round(nv ** 0.5))
    gen = torch.Generator(device=DEV).manual_seed(21)
    vis = (torch.randn((b, nv, cfg.d_model), generator=gen, device=DEV)
           * 0.02).to(opts.dtype)
    pos = torch.zeros((3, b, t + 1), dtype=torch.int32, device=DEV)
    grid = torch.arange(nv, device=DEV, dtype=torch.int32)
    pos[1, :, :nv], pos[2, :, :nv] = grid // side, grid % side
    pos[:, :, nv:] = (torch.arange(t + 1 - nv, device=DEV,
                                   dtype=torch.int32) + side)
    prefill_step, decode_step = make_serve_step(cfg, ServeConfig(), opts)
    toks = torch.as_tensor(pad, device=DEV)
    cache = init_cache(cfg, b, t + 1, opts, device=DEV)
    text, _ = prefill_step(params, toks, init_cache(cfg, b, t + 1, opts,
                                                    device=DEV))
    text = text.clone()          # not a view of the whole prefill's logits
    begin_path(ops, "fam_qwen2_vision")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = prefill_step(params, toks, cache, vision_embeds=vis,
                                 positions=pos[:, :, :t])
    tok = torch.argmax(logits, -1).to(torch.int32)
    logits1, cache = decode_step(params, tok[:, None], cache,
                                 positions=pos[:, :, t:])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launches["fam_qwen2_vision"] = end_path(ops)
    check(counts["flash_attention"] == 2 * cfg.n_layers,
          f"qwen2-vl vision: K-F launched {counts['flash_attention']} times, "
          f"expected {2 * cfg.n_layers}")
    check(bool(torch.isfinite(logits).all() and torch.isfinite(logits1).all())
          and logits.shape == (b, cfg.vocab),
          "qwen2-vl vision: malformed logits")
    moved = float((logits - text).abs().max())
    check(moved > 0, "qwen2-vl vision: the vision embeddings changed nothing")
    print(f"[{card}] qwen2-vl with {nv} vision embeddings on a {side} x "
          f"{side} (t, h, w) grid: one prefill (b={b}, {t} tokens) and one "
          f"decode step in {wall:.3f} s, M-RoPE over 3-axis positions; "
          f"last-position logits move by up to {moved:.3e} from the "
          f"text-only prefill's; launches {counts}", flush=True)
    return dict(wall_s=wall, launches=counts, max_logit_move=moved)


def serve_whisper(card, torch, launches) -> dict:
    """whisper-small at full width and depth (12 + 12 layers, bf16):
    seeded stub frames (8, 1,500, 768) → ``encode`` once → ``prefill_step
    (enc_out=)`` of 8 prompts of 16-224 tokens → 32 greedy
    ``decode_step``s, counted (K-F 12 + 24 × 33); the layer check with
    the encoder's calls."""
    import numpy as np
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.models import (ModelOptions, count_params, encode,
                                    init_cache, init_params)
    from repro_torch.serve import ServeConfig, make_serve_step
    cfg = configs.get_arch(WHISPER_ARCH)
    opts = ModelOptions(dtype=torch.bfloat16)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, torch.Generator(device=DEV).manual_seed(0),
                         opts, device=DEV)
    n_params = count_params(params)
    gen = torch.Generator(device=DEV).manual_seed(22)
    frames = torch.randn((FAM_BATCH, cfg.enc_len, cfg.d_model),
                         generator=gen, device=DEV).to(opts.dtype)
    rng = np.random.default_rng(22)
    lens = [int(rng.integers(WHISPER_PROMPT[0], WHISPER_PROMPT[1] + 1))
            for _ in range(FAM_BATCH)]
    tmax = max(lens)
    pad = np.zeros((FAM_BATCH, tmax), np.int32)
    for r, m in enumerate(lens):
        pad[r, tmax - m:] = rng.integers(0, cfg.vocab, m)
    prefill_step, decode_step = make_serve_step(cfg, ServeConfig(), opts)
    decode_ms = []
    begin_path(ops, "fam_whisper")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    enc = encode(params, cfg, frames, opts)
    torch.cuda.synchronize()
    t_enc = time.perf_counter() - t0
    cache = init_cache(cfg, FAM_BATCH, tmax + WHISPER_NEW, opts, device=DEV)
    logits, cache = prefill_step(params, torch.as_tensor(pad, device=DEV),
                                 cache, enc_out=enc)
    torch.cuda.synchronize()
    t_pre = time.perf_counter() - t0 - t_enc
    gen_tok = []
    for _ in range(WHISPER_NEW):
        tok = torch.argmax(logits, -1).to(torch.int32)
        gen_tok.append(tok)
        t1 = time.perf_counter()
        logits, cache = decode_step(params, tok[:, None], cache, enc_out=enc)
        torch.cuda.synchronize()
        decode_ms.append((time.perf_counter() - t1) * 1e3)
    t_gen = time.perf_counter() - t0
    counts = launches["fam_whisper"] = end_path(ops)
    peak = torch.cuda.max_memory_allocated()
    per = attention_calls(cfg)
    want_fa = cfg.n_enc_layers + per * (WHISPER_NEW + 1)
    check(counts["flash_attention"] == want_fa,
          f"whisper: K-F launched {counts['flash_attention']} times, "
          f"expected {cfg.n_enc_layers} + {per} x {WHISPER_NEW + 1} = "
          f"{want_fa}")
    toks = torch.stack(gen_tok, 1)
    check(bool(torch.isfinite(enc.float()).all())
          and bool(((toks >= 0) & (toks < cfg.vocab)).all())
          and bool(torch.isfinite(logits).all()),
          "whisper: non-finite encoder output or malformed tokens")
    tps = FAM_BATCH * WHISPER_NEW / t_gen
    print(f"[{card}] {WHISPER_ARCH} (bf16, {n_params} parameters, "
          f"{cfg.n_enc_layers} encoder + {cfg.n_layers} decoder layers): "
          f"stub frames {tuple(frames.shape)} encoded in {t_enc * 1e3:.3f} "
          f"ms; {FAM_BATCH} prompts of {min(lens)}-{tmax} tokens prefilled "
          f"with enc_out in {t_pre * 1e3:.3f} ms; {WHISPER_NEW} greedy "
          f"tokens each in {t_gen:.3f} s all told = {tps:.1f} tokens/s; "
          f"decode ms per step median {float(np.median(decode_ms)):.3f}; "
          f"peak memory {peak / 2 ** 30:.3f} GiB; launches {counts}",
          flush=True)
    worst = layer_check(
        card, torch, cfg, params, opts, pad, WHISPER_ARCH,
        calls=cfg.n_enc_layers + 2 * per,
        extra=lambda: dict(enc_out=encode(params, cfg, frames, opts)))
    del params, enc, cache
    torch.cuda.empty_cache()
    return dict(arch=WHISPER_ARCH, params=n_params, encode_ms=t_enc * 1e3,
                prefill_ms=t_pre * 1e3, tokens_per_s=tps, decode_ms=decode_ms,
                decode_ms_median=float(np.median(decode_ms)),
                peak_bytes=peak, launches=counts, layer_check_worst=worst)


def phase_families(card, torch, rt, launches) -> tuple:
    """20. The other families on the card: (a) K-F vs its plain version at
    their shapes (``family_kf_cases``); (b) recurrentgemma-9b, xlstm-350m
    and qwen2-vl-7b at full width and depth through ``BatchedServer`` +
    ``make_knn_hook`` over phase 14's 1,048,576 × 32 keys
    (``serve_family``; qwen2-vl also with vision embeddings); (c)
    whisper-small through ``encode`` and ``make_serve_step``
    (``serve_whisper``); (d) each reduced config card vs CPU
    (``reduced_family``). Returns (K-F's cases, the phase's numbers)."""
    import numpy as np
    from repro_torch import configs
    from repro_torch.serve import Datastore, KnnLMConfig
    t_phase = time.perf_counter()
    cases = family_kf_cases(card, torch)
    rng = np.random.default_rng(14)          # phase 14's keys
    keys = rng.standard_normal((LM_STORE_KEYS, LM_STORE_DIM),
                               dtype=np.float32)
    # values in the smallest of the three vocabularies, valid in each
    vocab = min(configs.get_arch(arch).vocab for arch in FAMILY_ARCHS)
    vals = rng.integers(0, vocab, LM_STORE_KEYS).astype(np.int32)
    store = Datastore.build(keys, vals, k=8, n_pivots=128, n_groups=8,
                            device=DEV)
    kcfg = KnnLMConfig(lam=0.2, tau=50.0, k=8)
    out = {}
    for arch in FAMILY_ARCHS:
        out[arch] = serve_family(card, torch, arch, store, keys, kcfg,
                                 launches)
    del store
    torch.cuda.empty_cache()
    out[WHISPER_ARCH] = serve_whisper(card, torch, launches)
    rng = np.random.default_rng(20)
    for arch in FAMILY_ARCHS + (WHISPER_ARCH,):
        out[f"reduced_{arch}"] = reduced_family(card, torch, arch, rng)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[{card}] phase 20 (recurrent, hybrid, audio, VLM) "
          f"{out['phase_s']:.3f} s", flush=True)
    return cases, out


TRAIN_ARCH = "llama3.2-3b"        # phase 21: trained at full width and depth
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 1024, 8
TRAIN_LR = 1e-3                    # the launcher's default (warmup 10 steps)
# K-B's shapes (phase 21): b, nq, nk, h, kvh, d, causal, window, d_v (the v
# columns used: MLA's expanded form pads v from 128 to 192)
KB_SHAPES = (
    ("llama3.2-3b train", 4, 1024, 1024, 24, 8, 128, True, None, None),
    ("recurrentgemma-9b causal (window = T)", 2, 2048, 2048, 16, 1, 256,
     True, 2048, None),
    ("recurrentgemma-9b windowed (T 4,096)", 1, 4096, 4096, 16, 1, 256,
     True, 2048, None),
    ("whisper-small encoder", 4, 1500, 1500, 12, 12, 64, False, None, None),
    ("whisper-small cross-attention", 4, 224, 1500, 12, 12, 64, False, None,
     None),
    ("deepseek-v2-lite-16b expanded MLA", 2, 1024, 1024, 16, 16, 192, True,
     None, 128),
)


# K-B's bf16 time at each shape on its first form, fp32 FMAs on CUDA cores,
# as PERF.md §6 records it (NVIDIA H100 80GB HBM3, 700.00 W): printed beside
# this run's time, never measured here and kept out of the kernels line
KB_SIMT_MS = {
    "llama3.2-3b train": 7.7404,
    "recurrentgemma-9b causal (window = T)": 46.3749,
    "recurrentgemma-9b windowed (T 4,096)": 53.1490,
    "whisper-small encoder": 7.0027,
    "whisper-small cross-attention": 1.2222,
    "deepseek-v2-lite-16b expanded MLA": 4.4352,
}


def capped_flex(torch, q, k, v, *, causal: bool, window, cap: float,
                grad: bool = False):
    """One PyTorch call that computes K-F's capped function, the capped
    rows' ``library_ms``: ``flex_attention`` under ``torch.compile``, with
    the tanh cap as its ``score_mod`` (on the scaled logits, as K-F caps
    them) and the causal / window mask (queries right-aligned) as a block
    mask, GQA by ``enable_gqa``, on (b, h, n, d) copies of q, k, v
    (``grad``: copies that take gradients, for K-B's yardstick). The port
    never calls it. Returns (the call, the copies)."""
    import torch._dynamo
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)
    for name in ("recompile_limit", "cache_size_limit"):
        if hasattr(torch._dynamo.config, name):   # one compile a shape
            setattr(torch._dynamo.config, name, 64)
    nq, nk = q.shape[1], k.shape[1]
    block_mask = None
    if causal:
        block_mask = create_block_mask(_flex_mask(nk - nq, window), None,
                                       None, nq, nk, device=DEV)
    else:
        assert window is None, "a window is causal in K-F"
    ts = tuple(x.transpose(1, 2).contiguous().requires_grad_(grad)
               for x in (q, k, v))
    fn = torch.compile(flex_attention, dynamic=False)
    score_mod = _flex_cap(cap)
    return (lambda: fn(*ts, score_mod=score_mod, block_mask=block_mask,
                       enable_gqa=True)), ts


@functools.lru_cache(maxsize=None)
def _flex_cap(cap: float):
    """``capped_flex``'s score_mod, one function a cap (a compile made for
    one shape is then found again by another case of that shape)."""
    import torch

    def score_mod(score, b, h, i, j):
        return cap * torch.tanh(score / cap)
    return score_mod


@functools.lru_cache(maxsize=None)
def _flex_mask(off: int, window):
    """``capped_flex``'s causal / window mask_mod, one function a shape."""
    def mask_mod(b, h, i, j):
        seen = j <= i + off
        if window is not None:
            seen = seen & (j > i + off - window)
        return seen
    return mask_mod


def f64_witness(torch, q, k, v, *, cap: float):
    """K-F's causal capped function (queries right-aligned) in float64 on
    the card, one batch row at a time: (out, Σ p·|v|), both (b, nq, h,
    d_v) float64."""
    b, nq, h, d = q.shape
    nk, rep = k.shape[1], h // k.shape[2]
    out = torch.empty(q.shape[:3] + v.shape[3:], dtype=torch.float64,
                      device=DEV)
    terms = torch.empty_like(out)
    hidden = (torch.arange(nk, device=DEV)[None]
              > torch.arange(nq, device=DEV)[:, None] + (nk - nq))
    for r in range(b):
        qq = q[r].double().transpose(0, 1)
        kk, vv = (x[r].double().transpose(0, 1).repeat_interleave(rep, 0)
                  for x in (k, v))
        s = (qq @ kk.transpose(1, 2)) * d ** -0.5
        s = (cap * torch.tanh(s / cap)).masked_fill_(hidden, float("-inf"))
        pr = torch.softmax(s, -1)
        del s
        out[r] = (pr @ vv).transpose(0, 1)
        terms[r] = (pr @ vv.abs()).transpose(0, 1)
        del pr
    return out, terms


def rel_norm(a, b) -> float:
    """‖a − b‖ / ‖b‖ in float32."""
    return float((a.float() - b.float()).norm() / (b.float().norm() + 1e-30))


def kb_case(card, torch, what, b, nq, nk, h, kvh, d, causal, window,
            d_v, softcap: float = 0.0, amp: float = 1.0) -> dict:
    """K-B vs its plain version on the same bf16 inputs and K-F's lse:
    ‖Δ‖ / ‖ref‖ of dq, dk and dv within 2⁻⁸ (both sum in float32 in
    other orders and round once to bf16: one rounding is ≤ 2⁻⁸ relative
    per entry; K-B also feeds p and dS to the tensor cores as two bf16
    terms, 2⁻¹⁷ relative), every entry finite, dv's padded columns 0, a
    repeated launch the same bits and the plan's route "mma" (its tiles
    and row splits printed); K-B timed beside the plain version, SDPA's
    backward (``torch.autograd.grad`` of one SDPA output with a contiguous
    dO, the graph kept) and its forward, each by ``device_ms`` (its host
    enqueue swung SDPA's backward 0.27-4.1 ms under plain events); its first, CUDA-core form's
    recorded time at the shape (``KB_SIMT_MS``, where there is one) is
    printed, not returned. ``softcap`` caps the logits, and the library
    call is then ``capped_flex``'s (its backward and forward, the same
    way), and ``amp`` scales q and k (logits the cap bends).
    The bound is the larger of the bytes (q, k, v, o,
    dO, lse read once, dq, dk, dv written once; v, o, dO and dv at the
    ``d_v`` columns the function uses) at the HBM rate and the
    operations at the bf16 tensor-core peak, the inputs' type: per
    visible (query, key, head) 2·(3d + 2·d_v), for S = q·kᵀ, dk and dq
    at d and dP = dO·vᵀ and dv at d_v."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as kf
    gen = torch.Generator(device=DEV).manual_seed(21 + d)
    bf = torch.bfloat16

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=DEV).to(bf)

    q, k, v = rand(b, nq, h, d), rand(b, nk, kvh, d), rand(b, nk, kvh, d)
    do = rand(b, nq, h, d)
    if amp != 1.0:
        q, k = ((x * amp).to(bf) for x in (q, k))
    if d_v is not None:
        v[..., d_v:] = 0
        do[..., d_v:] = 0
    kw = dict(causal=causal, window=window, softcap=softcap)
    out, lse = kf.flash_attention_cuda(q, k, v, return_lse=True, **kw)
    got = kf.flash_attention_bwd_cuda(q, k, v, out, do, lse, **kw)
    plan = kf.last_bwd_plan
    check(plan.route == "mma", f"K-B ({what}): bf16 planned on route "
          f"{plan.route}, not the tensor cores")
    want = kf.flash_attention_bwd_plain(q, k, v, out, do, lse, **kw)
    torch.cuda.synchronize()
    errs = [rel_norm(g, w) for g, w in zip(got, want)]
    check(all(bool(torch.isfinite(g.float()).all()) for g in got),
          f"K-B ({what}): non-finite gradient")
    check(max(errs) <= 2.0 ** -8, f"K-B ({what}): ‖Δ‖/‖ref‖ of dq, dk, dv "
          f"{errs} past 2^-8 against the plain version")
    if d_v is not None:
        check(bool((got[2][..., d_v:] == 0).all()),
              f"K-B ({what}): dv's padded columns are not 0")
    again = kf.flash_attention_bwd_cuda(q, k, v, out, do, lse, **kw)
    check(all(torch.equal(x, y) for x, y in zip(got, again)),
          f"K-B ({what}): a repeated launch gives other bits")
    max_err = max(float((g.float() - w.float()).abs().max())
                  for g, w in zip(got, want))
    del want, again
    ms = device_ms(torch, lambda: kf.flash_attention_bwd_cuda(
        q, k, v, out, do, lse, **kw))
    plain_ms = time_ms(lambda: kf.flash_attention_bwd_plain(
        q, k, v, out, do, lse, **kw), warmup=1, iters=1)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    dot = do.transpose(1, 2).contiguous()
    mask = None
    if window is not None:
        pos = torch.arange(nq, device=DEV)[:, None] + (nk - nq)
        key = torch.arange(nk, device=DEV)[None, :]
        mask = (key <= pos) & (key > pos - window)
    sdpa_kw = dict(enable_gqa=True, attn_mask=mask,
                   is_causal=causal and mask is None and nq == nk)
    lib = "SDPA"
    t0 = time.perf_counter()
    if softcap:
        lib = "flex_attention (compiled, tanh-cap score_mod)"
        library, (qt, kt, vt) = capped_flex(
            torch, q, k, v, causal=causal, window=window, cap=softcap,
            grad=True)
    else:
        def library():
            return F.scaled_dot_product_attention(qt, kt, vt, **sdpa_kw)
    ref = library()
    lib_grads = torch.autograd.grad(ref, (qt, kt, vt), dot,
                                    retain_graph=True)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0      # flex: its compile
    lib_err = max(float((g.transpose(1, 2).float() - w.float()).abs().max())
                  for g, w in zip(lib_grads, got))
    del lib_grads
    lib_ms = device_ms(torch, lambda: torch.autograd.grad(
        ref, (qt, kt, vt), dot, retain_graph=True), iters=20)
    if softcap:       # through the graph that the backward was built on
        fwd_ms = device_ms(torch, library)
    else:
        with torch.no_grad():
            fwd_ms = device_ms(torch, library)
    del ref, qt, kt, vt, dot
    pos = torch.arange(nq, device=DEV, dtype=torch.float64) + (nk - nq)
    lo = torch.zeros_like(pos) if window is None else \
        torch.clamp(pos - window + 1, min=0)
    hi = torch.full_like(pos, nk - 1)
    if causal:
        hi = torch.minimum(pos, hi)
    pairs = float(b * h * torch.clamp(hi - lo + 1, min=0).sum())
    used = (d if d_v is None else d_v) / d     # v's share of columns used
    n_bytes = float(q.element_size()) * (
        2 * q.numel() + 2 * k.numel()
        + used * (out.numel() + do.numel() + 2 * v.numel())) \
        + 4.0 * lse.numel()
    ops_n = 2.0 * (3 * d + 2 * used * d) * pairs
    t_b = n_bytes / H100_HBM_BYTES_S * 1e3
    t_f = ops_n / H100_BF16_FLOPS_S * 1e3
    b_ms, b_by = (t_b, "bytes") if t_b >= t_f else (t_f, "operations")
    old_ms = KB_SIMT_MS.get(what)
    print(f"[{card}] K-B flash attention backward ({what}) q "
          f"{tuple(q.shape)} kv {tuple(k.shape)} bf16"
          + ("" if causal else " non-causal")
          + ("" if window is None else f" window {window}")
          + (f" cap {softcap}" if softcap else "")
          + ("" if d_v is None else f" v padded from {d_v}")
          + f": route {plan.route}, width {plan.width}, {plan.key_tile} keys"
          f" a dk/dv block in steps of {plan.step_rows} rows, "
          f"{plan.row_tile} rows a dq block, {plan.splits} row splits; "
          f"‖Δ‖/‖ref‖ dq {errs[0]:.3e} dk {errs[1]:.3e} dv "
          f"{errs[2]:.3e} (limit 2^-8), max |err| {max_err:.3e}; kernel "
          f"{ms:.4f} ms"
          + ("" if old_ms is None else
             f" (its CUDA-core form's recorded {old_ms:.4f} ms, PERF.md §6, "
             f"{old_ms / ms:.2f}x)")
          + f", plain {plain_ms:.4f} ms, {lib} backward "
          f"{lib_ms:.4f} ms (its forward {fwd_ms:.4f} ms; its gradients "
          f"max |diff| {lib_err:.3e} from K-B's; its first forward and "
          f"backward {first_s:.1f} s); bound "
          f"{b_ms:.4f} ms ({b_by}: {pairs:.4e} visible pairs x 2(3d + "
          f"2d_v) bf16 operations, {n_bytes:.4e} bytes)", flush=True)
    return dict(shape=what, max_abs_err=max_err, rel_errs=errs, ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms, sdpa_forward_ms=fwd_ms,
                library=lib, library_max_abs_diff=lib_err,
                route=plan.route, width=plan.width,
                key_tile=plan.key_tile, step_rows=plan.step_rows,
                row_tile=plan.row_tile, splits=plan.splits, softcap=softcap)


def kf_lse_checks(card, torch) -> list:
    """K-F's output with and without lse, bit for bit, at the dense
    prefill (tensor cores), decode (split-KV + combine) and MLA's
    absorbed (d = 576, CUDA cores) and expanded (d = 192) shapes; lse
    against the plain version's (−inf at the same rows, finite rows within
    1e-4: both take m + log l in float32 over sums in other orders)."""
    from repro_torch.kernels import flash_attention as kf
    gen = torch.Generator(device=DEV).manual_seed(211)
    shapes = (("dense prefill", 4, 1024, 1024, 24, 8, 128),
              ("dense decode", 8, 1, 2080, 24, 8, 128),
              ("MLA absorbed prefill", 2, 512, 512, 16, 1, 576),
              ("MLA absorbed decode", 8, 1, 2064, 16, 1, 576),
              ("MLA expanded prefill", 2, 1024, 1024, 16, 16, 192))
    out = []
    for what, b, nq, nk, h, kvh, d in shapes:
        q, k = (torch.randn(s, generator=gen, device=DEV).to(torch.bfloat16)
                for s in ((b, nq, h, d), (b, nk, kvh, d)))
        v = k if kvh == 1 else torch.randn(
            (b, nk, kvh, d), generator=gen, device=DEV).to(torch.bfloat16)
        o1 = kf.flash_attention_cuda(q, k, v)
        o2, lse = kf.flash_attention_cuda(q, k, v, return_lse=True)
        plan = kf.last_plan
        _, ref = kf.flash_attention_plain(q, k, v, return_lse=True)
        check(torch.equal(o1, o2), f"K-F ({what}): the output differs with "
              f"lse")
        check(torch.equal(torch.isinf(lse), torch.isinf(ref)),
              f"K-F ({what}): lse is -inf at other rows than the plain "
              f"version's")
        fin = torch.isfinite(ref)
        err = float((lse[fin] - ref[fin]).abs().max())
        check(err <= 1e-4, f"K-F ({what}): lse off the plain version's by "
              f"{err:.3e}")
        print(f"[{card}] K-F with lse ({what}, d {d}, route {plan.route}, "
              f"{plan.splits} key splits): output bitwise equal without "
              f"lse; lse max |err| {err:.3e} vs the plain version",
              flush=True)
        out.append(dict(shape=what, lse_max_abs_err=err, route=plan.route))
    return out


def reduced_training(card, torch) -> dict:
    """The reduced llama3.2-3b in float32, card against CPU (same weights,
    same batch): ``loss_and_grads`` (loss within 1e-5 rel, each gradient
    leaf within 2e-5 of its largest entry: the CPU's plain backward and
    K-B sum in other orders); one ``make_train_step`` step (loss and grad
    norm within 1e-5 rel); ``accum=4`` against ``accum=1`` on the
    concatenated batch, on the card (loss 1e-5, parameters 1e-5 abs + 1e-4
    rel, the JAX ``test_accum_equivalence`` limits); AdamW and Adafactor
    fed the CPU's gradients on both devices (each parameter leaf within
    1e-5 of its largest entry); and the restart: 4 steps straight against
    2 steps, ``checkpoint.save``, ``restore`` and 2 more, the parameters
    and the AdamW state bitwise equal."""
    import tempfile
    import numpy as np
    from repro_torch import configs
    from repro_torch.data import DataConfig, synthetic_lm_batch
    from repro_torch.models import ModelOptions, init_params
    from repro_torch.train import (OptConfig, TrainConfig, checkpoint,
                                   make_optimizer, make_train_step)
    from repro_torch.train.train_step import loss_and_grads
    from repro_torch.tree import leaves_with_path, path_str, tree_map
    cfg = configs.get_reduced(TRAIN_ARCH)
    opts = ModelOptions(dtype=torch.float32, remat=True)
    cpu_p = init_params(cfg, torch.Generator().manual_seed(21), opts,
                        device="cpu")
    dev_p = to_device(cpu_p)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=128, global_batch=8)
    batch = {k: torch.as_tensor(v) for k, v in
             synthetic_lm_batch(dcfg, 0).items()}
    dbatch = {k: v.to(DEV) for k, v in batch.items()}

    def worst(a_tree, b_tree) -> float:
        """The largest per-leaf max |a − b| / max |b|."""
        bb = dict(leaves_with_path(b_tree))
        out = 0.0
        for path, a in leaves_with_path(a_tree):
            b = bb[path].to(a.device)
            out = max(out, float((a - b).abs().max())
                      / (float(b.abs().max()) + 1e-30))
        return out

    l_cpu, g_cpu = loss_and_grads(cpu_p, cfg, batch, opts, 1e-4)
    l_dev, g_dev = loss_and_grads(dev_p, cfg, dbatch, opts, 1e-4)
    g_err = worst(tree_map(torch.Tensor.cpu, g_dev), g_cpu)
    l_err = abs(float(l_dev) - float(l_cpu)) / abs(float(l_cpu))
    check(l_err <= 1e-5 and g_err <= 2e-5,
          f"reduced training: card loss {float(l_dev)} vs CPU "
          f"{float(l_cpu)}, gradients {g_err:.3e} of the largest entry "
          f"(limit 2e-5)")
    ms = {}
    for where, p, bt in (("cpu", cpu_p, batch), ("card", dev_p, dbatch)):
        init, step = make_train_step(cfg, TrainConfig(), opts)
        ms[where] = step(p, init(p), bt)[2]
    s_err = max(abs(float(ms["card"][k]) - float(ms["cpu"][k]))
                / abs(float(ms["cpu"][k])) for k in ("loss", "grad_norm"))
    check(s_err <= 1e-5, f"reduced training: a train step's loss or grad "
          f"norm {s_err:.3e} off the CPU's")
    # accum=4 against accum=1 on the card
    ocfg = OptConfig(grad_clip=1e9)
    res = {}
    for accum in (1, 4):
        init, step = make_train_step(cfg, TrainConfig(opt=ocfg, accum=accum,
                                                      z_loss=0.0), opts)
        bt = dbatch if accum == 1 else {
            k: v.reshape(4, 2, -1) for k, v in dbatch.items()}
        res[accum] = step(dev_p, init(dev_p), bt)
    a_loss = abs(float(res[1][2]["loss"]) - float(res[4][2]["loss"]))
    a_ok = all(bool(torch.isclose(a, b, atol=1e-5, rtol=1e-4).all())
               for (_, a), (_, b) in zip(leaves_with_path(res[1][0]),
                                         leaves_with_path(res[4][0])))
    check(a_loss <= 1e-5 * abs(float(res[1][2]["loss"])) and a_ok,
          f"reduced training: accum=4 differs from accum=1 on the card "
          f"(loss {a_loss:.3e})")
    # the optimizers on the same gradients, CPU against card
    o_err = {}
    for name in ("adamw", "adafactor"):
        init, update = make_optimizer(OptConfig(name=name, lr=1e-2,
                                                warmup_steps=0), cfg)
        new = {}
        for where, p in (("cpu", cpu_p), ("card", dev_p)):
            g = g_cpu if where == "cpu" else to_device(g_cpu)
            new[where], _, _ = update(g, init(p), p)
        o_err[name] = worst(tree_map(torch.Tensor.cpu, new["card"]),
                             new["cpu"])
        check(o_err[name] <= 1e-5, f"reduced training: {name} on the card "
              f"{o_err[name]:.3e} off the CPU's on the same gradients")
    # restart: 4 steps straight against 2 + save / restore + 2
    tcfg = TrainConfig(opt=OptConfig(lr=1e-3, warmup_steps=2,
                                     decay_steps=4))
    init, step = make_train_step(cfg, tcfg, opts)

    def run(params, opt, lo, hi):
        for i in range(lo, hi):
            b = {k: torch.as_tensor(v, device=DEV) for k, v in
                 synthetic_lm_batch(DataConfig(vocab=cfg.vocab, seq_len=64,
                                               global_batch=4), i).items()}
            params, opt, _ = step(params, opt, b)
        return params, opt

    p4, o4 = run(dev_p, init(dev_p), 0, 4)
    p2, o2 = run(dev_p, init(dev_p), 0, 2)
    with tempfile.TemporaryDirectory() as tmp:
        checkpoint.save(tmp, 2, {"params": p2, "opt": o2})
        fresh = init_params(cfg, torch.Generator(device=DEV).manual_seed(5),
                            opts, device=DEV)
        restored, at = checkpoint.restore(
            tmp, {"params": fresh, "opt": init(fresh)})
    check(at == 2, f"restart: restored step {at}")
    pr, orr = run(restored["params"], restored["opt"], 2, 4)
    same = {path_str(path): torch.equal(a, b) for (path, a), (_, b) in zip(
        leaves_with_path({"params": p4, "opt": o4}),
        leaves_with_path({"params": pr, "opt": orr}))}
    check(all(same.values()), f"restart: not bitwise at "
          f"{[k for k, v in same.items() if not v][:5]}")
    print(f"[{card}] reduced {TRAIN_ARCH} training (fp32, remat), card vs "
          f"CPU: loss rel diff {l_err:.3e}, gradients {g_err:.3e} of each "
          f"leaf's largest entry (limit 2e-5); one train step's loss and "
          f"grad norm {s_err:.3e} (limit 1e-5); accum=4 vs accum=1 on the "
          f"card: loss diff {a_loss:.3e}, parameters within 1e-5 + 1e-4 rel; "
          f"AdamW / Adafactor on the same gradients {o_err['adamw']:.3e} / "
          f"{o_err['adafactor']:.3e} (limit 1e-5); restart after 2 of 4 "
          f"steps (save, restore): {len(same)} leaves of the parameters and "
          f"AdamW state bitwise equal", flush=True)
    return dict(grad_err=g_err, loss_rel_err=l_err, step_err=s_err,
                accum_loss_diff=a_loss, opt_err=o_err,
                restart_leaves_equal=len(same))


def profile_train_step(card, torch, out_file: Path) -> dict:
    """One full-width training step of phase 21's configuration (seeded
    weights, AdamW, remat, the stream's step 0) under torch.profiler,
    after a warm-up step: the device's busy share of the step's
    CUDA-event time, and the device time of K-B (``bwd_*``), K-F
    (``fa_*``), the matrix products (GEMM kernels) and the rest
    (elementwise, reductions, copies: the optimizer, norms, the loss).
    The profiler's host overhead lengthens the window, so the busy share
    is a lower bound; a profiler that records no device time is reported
    as not measured. Every kernel's time goes to ``out_file``."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import configs
    from repro_torch.data import DataConfig, synthetic_lm_batch
    from repro_torch.models import ModelOptions, init_params
    from repro_torch.train import OptConfig, TrainConfig, make_train_step
    cfg = configs.get_arch(TRAIN_ARCH)
    opts = ModelOptions(dtype=torch.bfloat16, remat=True,
                        max_abs_pos=max(4096, TRAIN_SEQ))
    init, step = make_train_step(cfg, TrainConfig(opt=OptConfig(
        lr=TRAIN_LR, warmup_steps=10, decay_steps=TRAIN_STEPS)), opts)
    params = init_params(cfg, torch.Generator(device=DEV).manual_seed(0),
                         opts, device=DEV)
    state = {"params": params, "opt": init(params)}
    del params
    batch = {k: torch.as_tensor(v, device=DEV) for k, v in
             synthetic_lm_batch(DataConfig(vocab=cfg.vocab,
                                           seq_len=TRAIN_SEQ,
                                           global_batch=TRAIN_BATCH),
                                0).items()}

    def one():
        state["params"], state["opt"], _ = step(state["params"],
                                                state["opt"], batch)

    one()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start.record()
        one()
        end.record()
        torch.cuda.synchronize()
    wall = start.elapsed_time(end)
    kernels = sorted(((e.key, e.self_device_time_total / 1e3)
                      for e in prof.key_averages()
                      if e.device_type.name == "CUDA"
                      and e.self_device_time_total > 0),
                     key=lambda kv: -kv[1])
    del state, batch
    torch.cuda.empty_cache()
    busy = sum(ms for _, ms in kernels)
    if not busy:
        print(f"[{card}] training step profile: not measured (no device "
              f"time recorded)", flush=True)
        return {}
    out_file.write_text("".join(f"{ms:10.4f} ms  {name}\n"
                                for name, ms in kernels))
    groups = {"K-B": ("bwd_dsum", "bwd_dkdv", "bwd_dq"),
              "K-F": ("fa_mma", "fa_simt", "fa_combine"),
              "GEMM": ("gemm", "Gemm", "GEMM", "xmma", "cutlass",
                       "nvjet")}
    share = {name: sum(ms for key, ms in kernels
                       if any(m in key for m in marks))
             for name, marks in groups.items()}
    share["rest"] = busy - sum(share.values())
    print(f"[{card}] training step profile ({TRAIN_ARCH}, batch "
          f"{TRAIN_BATCH} x {TRAIN_SEQ}, AdamW, remat): {len(kernels)} "
          f"kernels, device busy {busy:.3f} ms of {wall:.3f} ms under the "
          f"profiler ({busy / wall:.1%}); "
          + ", ".join(f"{name} {ms:.3f} ms ({ms / busy:.1%})"
                      for name, ms in share.items())
          + f" (every kernel: {out_file})", flush=True)
    return dict(busy_ms=busy, wall_ms=wall, **{f"{k}_ms": v
                                              for k, v in share.items()})


def phase_training(card, torch, launches, out_dir: Path) -> tuple:
    """21. The train path on the card: (a) K-B's SASS holds tensor-core
    instructions, and K-B vs its plain version at the families' train
    shapes (``kb_case``); (b) K-F's output with and without
    lse (``kf_lse_checks``); (c) the reduced model card vs CPU, the
    optimizers, accumulation and a bitwise restart
    (``reduced_training``); (d) llama3.2-3b at full width and depth (28
    layers, bf16, seeded) through ``python -m repro_torch.launch.train``'s
    ``main``: AdamW, remat, batch 4 × 1,024 tokens, 8 steps, counted (K-F
    twice a layer a step, K-B once), every loss and grad norm finite and
    the last two losses' mean below the first two's; (e) one such step
    profiled (``profile_train_step``). Returns (K-B's cases, the phase's
    numbers)."""
    import numpy as np
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch_train
    t_phase = time.perf_counter()
    kb_mma = tensor_core_instructions(card, "flash_attn_bwd")
    cases = [kb_case(card, torch, *shape) for shape in KB_SHAPES]
    lse_cases = kf_lse_checks(card, torch)
    torch.cuda.empty_cache()
    reduced = reduced_training(card, torch)
    torch.cuda.empty_cache()
    cfg = configs.get_arch(TRAIN_ARCH)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    begin_path(ops, "train")
    t0 = time.perf_counter()
    run = launch_train.main(["--arch", TRAIN_ARCH, "--steps",
                             str(TRAIN_STEPS), "--seq", str(TRAIN_SEQ),
                             "--batch", str(TRAIN_BATCH), "--lr",
                             str(TRAIN_LR), "--device", DEV])
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    counts = launches["train"] = end_path(ops)
    peak = torch.cuda.max_memory_allocated()
    losses, norms, step_s = run["loss"], run["grad_norm"], run["step_s"]
    check(len(losses) == TRAIN_STEPS and all(
        np.isfinite(x) for x in losses + norms),
        f"training: non-finite loss or grad norm: {losses}, {norms}")
    check(np.mean(losses[-2:]) < np.mean(losses[:2]),
          f"training: the loss did not fall: {losses}")
    want_f = cfg.n_layers * 2 * TRAIN_STEPS
    want_b = cfg.n_layers * TRAIN_STEPS
    check(counts["flash_attention"] == want_f
          and counts["flash_attention_bwd"] == want_b,
          f"training: K-F / K-B launched {counts['flash_attention']} / "
          f"{counts['flash_attention_bwd']} times, expected {cfg.n_layers} "
          f"layers x 2 (remat) x {TRAIN_STEPS} = {want_f} / {want_b}")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    steady = float(np.median(step_s[1:]))
    # every token of steps 2..8 over the summed seconds of those steps
    tokens_per_s = tokens * (TRAIN_STEPS - 1) / float(np.sum(step_s[1:]))
    print(f"[{card}] training {TRAIN_ARCH} at full width and depth "
          f"({cfg.n_layers} layers, bf16, AdamW, remat; batch {TRAIN_BATCH} "
          f"x {TRAIN_SEQ} tokens, {TRAIN_STEPS} steps) through "
          f"launch.train: {t_run:.3f} s with init; s/step "
          + ", ".join(f"{x:.3f}" for x in step_s)
          + f" (steps 2-{TRAIN_STEPS}: {tokens_per_s:.1f} tokens/s over "
          f"their summed time; median {steady:.3f} s/step); loss "
          + ", ".join(f"{x:.4f}" for x in losses)
          + "; grad norm " + ", ".join(f"{x:.4f}" for x in norms)
          + f"; peak memory {peak / 2 ** 30:.3f} GiB; launches {counts}",
          flush=True)
    out = dict(kb_cases=cases, kb_sass_tensor_core=kb_mma, kf_lse=lse_cases,
               reduced=reduced,
               full=dict(loss=losses, grad_norm=norms, step_s=step_s,
                         s_per_step_median=steady,
                         tokens_per_s=tokens_per_s, peak_bytes=peak,
                         wall_s=t_run, launches=counts))
    torch.cuda.empty_cache()
    out["profile"] = profile_train_step(card, torch,
                                        out_dir / "train_profile.txt")
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[{card}] phase 21 (training) {out['phase_s']:.3f} s", flush=True)
    return cases, out


A6E_ARCH = "llama3.2-3b"     # phase 22: the capped and read-only paths
A6E_CAP = 50.0               # Gemma 2's attn_logit_softcapping
A6E_AMP = 1.5                # q, k scale of the capped kernel cases
A6E_AMP_HIGH = 3.0           # and of one capped prefill near the cap
A6E_TRAIN_STEPS = 4          # capped training: batch 4 x 1,024, AdamW, remat
A6E_READONLY_STEPS = 16      # read-only decode steps (phase 19 too)
# the sharded step: llama3.2-3b's full width cut to 8 of 28 layers (2
# simulated shards need 6.4 GB of gathered bf16 weights each, gradients and
# 38.5 GB of fp32 AdamW state at full depth: more than the card's 80 GB)
A6E_SHARD_LAYERS, A6E_SHARD_STEPS = 8, 2
# master weights after step 1 against one device's: the worst leaf's
# ‖ΔM‖ / ‖update‖ (AdamW's first update is ~lr·sign(g): the bf16 gradients'
# sums in another order flip the sign of the entries near 0, each by 2·lr;
# 0.109 / 0.112 at 2 / 4 shards on an H100 80GB HBM3 at 700 W) and its
# update's length, which those flips keep (6.2e-4 / 4.0e-4 there)
A6E_SHARD_UPDATE = (0.4, 0.005)


def bf16_close(torch, a, b) -> float:
    """max |a − b| over the limit one bf16 rounding of the larger
    magnitude of the two tensors puts on it (2⁻⁷ · max(|a|, |b|)), as a
    share (≤ 1 passes)."""
    a, b = a.float(), b.float()
    lim = 2.0 ** -7 * float(torch.maximum(a.abs().max(), b.abs().max()))
    return float((a - b).abs().max()) / max(lim, 1e-30)


def readonly_check(card, torch, cfg, params, opts, prompts, what: str,
                   path: str, launches) -> dict:
    """The read-only serving cache at full width: the prompts prefilled
    into a written cache and a copy of it, then ``A6E_READONLY_STEPS``
    teacher-forced steps (the written decode's greedy tokens fed to both):
    a read-only ``forward`` (counted under ``path``: K-F once an attention
    layer a step) whose input cache keeps every byte (compared with a
    copy taken before the step), its fresh pieces appended out of band
    (``append_readonly``), against the written-cache decode: logits within
    one bf16 rounding of the larger logit (``bf16_close``)."""
    import dataclasses as dc
    import numpy as np
    from repro_torch.kernels import ops
    from repro_torch.models import append_readonly, forward, init_cache
    from repro_torch.tree import leaves
    ro = dc.replace(opts, readonly_cache=True)
    tmax = max(map(len, prompts))
    pad = np.zeros((len(prompts), tmax), np.int32)
    for r, p in enumerate(prompts):
        pad[r, tmax - len(p):] = p
    written = init_cache(cfg, len(prompts), tmax + A6E_READONLY_STEPS, opts,
                         device=DEV)
    logits, written = forward(params, cfg, torch.as_tensor(pad, device=DEV),
                              cache=written, opts=opts, mode="prefill")
    # a copy in init_cache's layout (the read-only MLA path reads it in place)
    appended = init_cache(cfg, len(prompts), tmax + A6E_READONLY_STEPS, opts,
                          device=DEV)
    for a, b in zip(leaves(appended["layers"]), leaves(written["layers"])):
        a.copy_(b)
    appended["pos"] = written["pos"]
    tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
    worst, same, ro_ms, w_ms = 0.0, True, [], []
    kf_calls = 0
    for _ in range(A6E_READONLY_STEPS):
        before = [x.clone() for x in leaves(appended["layers"])]
        begin_path(ops, path)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got, fresh = forward(params, cfg, tok, cache=appended, opts=ro,
                             mode="decode")
        torch.cuda.synchronize()
        ro_ms.append((time.perf_counter() - t0) * 1e3)
        counts = end_path(ops)
        kf_calls += counts["flash_attention"]
        launches[path] = {k: launches.get(path, {}).get(k, 0) + v
                          for k, v in counts.items()}
        same = same and all(torch.equal(a, b) for a, b in
                            zip(before, leaves(appended["layers"])))
        del before
        t0 = time.perf_counter()
        want, written = forward(params, cfg, tok, cache=written, opts=opts,
                                mode="decode")
        torch.cuda.synchronize()
        w_ms.append((time.perf_counter() - t0) * 1e3)
        worst = max(worst, bf16_close(torch, got, want))
        appended = append_readonly(appended, fresh)
        tok = torch.argmax(want[:, -1], -1).to(torch.int32)[:, None]
    n_attn = attention_calls(cfg)
    check(same, f"{what} read-only decode: the input cache's bytes changed")
    check(kf_calls == n_attn * A6E_READONLY_STEPS,
          f"{what} read-only decode: K-F launched {kf_calls} times, expected "
          f"{n_attn} x {A6E_READONLY_STEPS}")
    check(worst <= 1.0, f"{what} read-only decode: logits {worst:.3f} of one "
          f"bf16 rounding off the written decode's")
    check(all(torch.equal(a, b) for a, b in zip(
        leaves(appended["layers"]), leaves(written["layers"]))),
          f"{what}: the appended cache differs from the written one")
    print(f"[{card}] {what} read-only cache: {len(prompts)} prompts of "
          f"{min(map(len, prompts))}-{tmax} tokens prefilled, "
          f"{A6E_READONLY_STEPS} teacher-forced read-only steps with the "
          f"fresh pieces appended out of band: the input cache's bytes "
          f"unchanged at every step; logits vs the written decode {worst:.4f}"
          f" of one bf16 rounding; the appended cache equals the written one "
          f"bit for bit; K-F {kf_calls} launches; step ms read-only median "
          f"{float(np.median(ro_ms)):.3f} (written {float(np.median(w_ms)):.3f})",
          flush=True)
    del written, appended
    torch.cuda.empty_cache()
    return dict(worst_bf16=worst, readonly_ms=ro_ms, written_ms=w_ms,
                kf_launches=kf_calls)


def a6e_kernel_cases(card, torch) -> tuple:
    """K-F with the cap in each form — the tensor-core prefill (causal,
    llama3.2-3b's prefill shape; windowed at recurrentgemma's shapes;
    non-causal at whisper's encoder) and the split-KV decode — and the
    read-only decode (the cache's live keys plus one fresh key as K-F's
    second source, bytes-bound) against their plain versions; K-B with
    the cap at phase 21's llama and recurrentgemma shapes on its bf16
    route. The capped cases' library call is ``capped_flex``'s (its
    output's max |diff| from the plain version printed); the read-only
    one times SDPA over the keys concatenated beforehand. q and k at
    ``A6E_AMP`` times the unit scale peak the softmax, so the K-F cases
    take phase 19's limit (``attention_case(cancel=True)``); one more
    capped prefill at ``A6E_AMP_HIGH`` (logits near the cap) is held to
    the same limit, and the kernel's and the plain version's outputs
    there are read against a float64 witness (``f64_witness``)."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as kf
    cfg_h, cfg_kvh, dh = 24, 8, 128
    gen = torch.Generator(device=DEV).manual_seed(22)

    def rand(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=DEV) * scale
                ).to(torch.bfloat16)

    flex = "flex_attention (compiled, tanh-cap score_mod)"

    def capped(what, q, k, v, *, causal=True, window=None):
        call, _ = capped_flex(torch, q, k, v, causal=causal, window=window,
                              cap=A6E_CAP)
        t0 = time.perf_counter()
        got = call()
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        diff = float((got.transpose(1, 2).float() - kf.flash_attention_plain(
            q, k, v, causal=causal, window=window, softcap=A6E_CAP).float()
        ).abs().max())
        del got
        print(f"[{card}] {flex} ({what}): max |diff| {diff:.3e} from K-F's "
              f"plain version; its first call {first_s:.1f} s", flush=True)
        case = attention_case(card, torch, what, q, k, v, causal=causal,
                              window=window, softcap=A6E_CAP, cancel=True,
                              library=call, library_name=flex)
        return dict(case, library=flex, library_max_abs_diff=diff)

    n = LM_PROMPT[1]
    cases = []
    # q and k at 1.5x the unit scale: logits up to ~±12, where a cap of 50
    # moves the output by ~0.08
    amp = A6E_AMP
    q, k, v = rand(LM_BATCH, n, cfg_h, dh, scale=amp), rand(
        LM_BATCH, n, cfg_kvh, dh, scale=amp), rand(LM_BATCH, n, cfg_kvh, dh)
    cases.append(capped(f"capped prefill b={LM_BATCH} nq=nk={n}", q, k, v))
    del q, k, v
    # at 3x: logits up to ~±40, near the cap, where the plain float32
    # version is itself ~4 bf16 roundings off a float64 witness at the
    # outputs that cancel toward 0 (phase 19's limit holds both)
    q, k, v = rand(LM_BATCH, n, cfg_h, dh, scale=A6E_AMP_HIGH), rand(
        LM_BATCH, n, cfg_kvh, dh, scale=A6E_AMP_HIGH), rand(
        LM_BATCH, n, cfg_kvh, dh)
    what = f"capped prefill at {A6E_AMP_HIGH:g}x b={LM_BATCH} nq=nk={n}"
    high = capped(what, q, k, v)
    out = kf.flash_attention_cuda(q, k, v, softcap=A6E_CAP)
    ref = kf.flash_attention_plain(q, k, v, softcap=A6E_CAP)
    w_out, w_terms = f64_witness(torch, q, k, v, cap=A6E_CAP)
    readings = {}
    for name, x in (("kernel", out), ("plain", ref)):
        err, used, old, *_ = attention_err_terms(torch, x, w_out, w_terms)
        readings[name] = dict(max_abs_err=err, limit_share=used,
                              one_rounding_share=old)
        print(f"[{card}] K-F ({what}): the {name} output against a float64 "
              f"witness: max |err| {err:.3e}, {used:.3f} of one rounding + "
              f"2^-14 sum p|v|, {old:.3f} of one bf16 rounding alone",
              flush=True)
    cases.append(dict(high, f64_witness=readings))
    del q, k, v, out, ref, w_out, w_terms
    torch.cuda.empty_cache()
    q, k, v = rand(2, n, 16, 256, scale=amp), rand(2, n, 1, 256, scale=amp), \
        rand(2, n, 1, 256)
    cases.append(capped(
        f"capped recurrentgemma windowed prefill b=2 nq=nk={n} h=16 kvh=1 "
        f"d=256", q, k, v, window=2048))
    del q, k, v
    q, k, v = rand(4, 1500, 12, 64, scale=amp), rand(4, 1500, 12, 64,
                                                      scale=amp), \
        rand(4, 1500, 12, 64)
    cases.append(capped("capped whisper encoder b=4 nq=nk=1500 (non-causal)",
                        q, k, v, causal=False))
    del q, k, v
    nk = n + LM_NEW
    kc, vc = rand(LM_BATCH, nk + 64, cfg_kvh, dh, scale=amp), rand(
        LM_BATCH, nk + 64, cfg_kvh, dh)
    q1 = rand(LM_BATCH, 1, cfg_h, dh, scale=amp)
    cases.append(capped(f"capped decode b={LM_BATCH} nq=1 nk={nk}", q1,
                        kc[:, :nk], vc[:, :nk]))
    # the read-only decode: the cache's live keys in place, one fresh key
    k1, v1 = rand(LM_BATCH, 1, cfg_kvh, dh, scale=amp), rand(LM_BATCH, 1,
                                                            cfg_kvh, dh)
    kcat = torch.cat([kc[:, :nk], k1], 1).transpose(1, 2)
    vcat = torch.cat([vc[:, :nk], v1], 1).transpose(1, 2)
    q1t = q1.transpose(1, 2)
    cases.append(attention_case(
        card, torch, f"read-only decode b={LM_BATCH} nq=1 nk={nk}+1", q1,
        kc[:, :nk], vc[:, :nk], causal=False, k_new=k1, v_new=v1,
        cancel=True, library=lambda: F.scaled_dot_product_attention(
            q1t, kcat, vcat, enable_gqa=True)))
    del kc, vc, q1, k1, v1, kcat, vcat, q1t
    torch.cuda.empty_cache()
    kb = [kb_case(card, torch, f"{name}, cap {A6E_CAP:g}", *shape,
                  softcap=A6E_CAP, amp=amp)
          for name, *shape in KB_SHAPES[:3]]
    torch.cuda.empty_cache()
    return cases, kb


def reduced_capped(card, torch) -> dict:
    """The capped reduced llama3.2-3b in fp32 card vs CPU, same weights:
    ``reduced_family``'s logits (2e-5 + 2e-5·|logit|) and greedy tokens;
    one read-only decode step over a prefilled cache (logits, the same
    limit); ``loss_and_grads`` (K-B's fp32 route with the cap): the loss
    within 1e-5 rel, each gradient leaf within 2e-5 of its largest
    entry."""
    import dataclasses as dc
    import numpy as np
    from repro_torch import configs
    from repro_torch.models import ModelOptions, forward, init_cache, init_params
    from repro_torch.tree import leaves_with_path, path_str
    from repro_torch.train.train_step import loss_and_grads
    cfg = dc.replace(configs.get_reduced(A6E_ARCH), attn_logit_softcap=A6E_CAP)
    rng = np.random.default_rng(22)
    out = dict(logits=reduced_family(card, torch, A6E_ARCH, rng, cfg=cfg))
    opts = ModelOptions(dtype=torch.float32, remat=False)
    cpu_p = init_params(cfg, torch.Generator().manual_seed(3), opts,
                        device="cpu")
    dev_p = to_device(cpu_p)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (4, 65)))
    got = {}
    for where, p, dev in (("cpu", cpu_p, "cpu"), ("card", dev_p, DEV)):
        c = init_cache(cfg, 4, 80, opts, device=dev)
        _, c = forward(p, cfg, toks[:, :64].to(dev), cache=c, opts=opts,
                       mode="prefill")
        got[where] = forward(p, cfg, toks[:, 64:].to(dev), cache=c,
                             opts=dc.replace(opts, readonly_cache=True),
                             mode="decode")[0].cpu()
    ro_diff = float((got["card"] - got["cpu"]).abs().max())
    check(bool(((got["card"] - got["cpu"]).abs()
                <= 2e-5 + 2e-5 * got["cpu"].abs()).all()),
          f"capped reduced read-only decode: card off the CPU by {ro_diff:.3e}")
    batch = {"tokens": toks[:, :64], "labels": torch.as_tensor(
        rng.integers(0, cfg.vocab, (4, 64)))}
    lc, gc = loss_and_grads(cpu_p, cfg, batch, opts, 1e-4)
    ld, gd = loss_and_grads(dev_p, cfg, to_device(batch), opts, 1e-4)
    check(abs(float(ld) - float(lc)) <= 1e-5 * abs(float(lc)),
          f"capped reduced loss: card {float(ld)} vs CPU {float(lc)}")
    worst = 0.0
    for (path, a), (_, b) in zip(leaves_with_path(gd), leaves_with_path(gc)):
        err = float((a.cpu() - b).abs().max()) / (float(b.abs().max()) + 1e-30)
        worst = max(worst, err)
        check(err <= 2e-5, f"capped reduced gradient {path_str(path)}: "
              f"{err:.3e} of its largest entry off the CPU's")
    print(f"[{card}] capped reduced {A6E_ARCH} (cap {A6E_CAP:g}, fp32): "
          f"read-only decode card vs CPU max |diff| {ro_diff:.3e} (limit "
          f"2e-5 + 2e-5·|logit|); loss card {float(ld):.7f} vs CPU "
          f"{float(lc):.7f}; gradients (K-B's fp32 route with the cap) worst "
          f"{worst:.3e} of a leaf's largest entry (limit 2e-5)", flush=True)
    out.update(readonly_max_abs_diff=ro_diff, grad_worst=worst)
    return out


def capped_training(card, torch, cfg, launches) -> dict:
    """The capped llama3.2-3b at full width and depth through
    ``make_train_step`` (AdamW, remat, batch 4 × 1,024 of
    ``synthetic_lm_batch``, ``A6E_TRAIN_STEPS`` steps), counted: K-F twice
    a layer a step, K-B once; every loss finite and the last below the
    first."""
    import numpy as np
    from repro_torch.data import DataConfig, synthetic_lm_batch
    from repro_torch.kernels import ops
    from repro_torch.models import ModelOptions, init_params
    from repro_torch.train import OptConfig, TrainConfig, make_train_step
    opts = ModelOptions(dtype=torch.bfloat16, remat=True,
                        max_abs_pos=max(4096, TRAIN_SEQ))
    init, step = make_train_step(cfg, TrainConfig(opt=OptConfig(
        lr=TRAIN_LR, warmup_steps=10, decay_steps=A6E_TRAIN_STEPS)), opts)
    params = init_params(cfg, torch.Generator(device=DEV).manual_seed(0),
                         opts, device=DEV)
    state = init(params)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                      global_batch=TRAIN_BATCH)
    losses, step_s = [], []
    begin_path(ops, "a6e_capped_train")
    for i in range(A6E_TRAIN_STEPS):
        batch = {k: torch.as_tensor(v, device=DEV)
                 for k, v in synthetic_lm_batch(dcfg, i).items()}
        t0 = time.perf_counter()
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
        step_s.append(time.perf_counter() - t0)
    counts = launches["a6e_capped_train"] = end_path(ops)
    want_f = cfg.n_layers * 2 * A6E_TRAIN_STEPS
    want_b = cfg.n_layers * A6E_TRAIN_STEPS
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"capped training: losses {losses}")
    check(counts["flash_attention"] == want_f
          and counts["flash_attention_bwd"] == want_b,
          f"capped training: K-F / K-B launched {counts['flash_attention']} "
          f"/ {counts['flash_attention_bwd']}, expected {want_f} / {want_b}")
    print(f"[{card}] capped {A6E_ARCH} training at full width and depth (cap "
          f"{A6E_CAP:g}, bf16, AdamW, remat, batch {TRAIN_BATCH} x "
          f"{TRAIN_SEQ}, {A6E_TRAIN_STEPS} steps): loss "
          + ", ".join(f"{x:.4f}" for x in losses) + "; s/step "
          + ", ".join(f"{x:.3f}" for x in step_s) + f"; launches {counts}",
          flush=True)
    del params, state
    torch.cuda.empty_cache()
    return dict(loss=losses, step_s=step_s, launches=counts)


def sharded_training(card, torch, launches) -> dict:
    """The FSDP step (``train.fsdp``) at llama3.2-3b's full width cut to
    ``A6E_SHARD_LAYERS`` layers (bf16, AdamW, remat, batch 4 × 1,024),
    every shard simulated on the card, against one device on the same
    weights and batches: ``A6E_SHARD_STEPS`` steps at 2 and 4 shards,
    counted; each step's loss within 3e-4 rel and grad norm within 1e-3
    rel of one device's (bf16: the shards' GEMMs see fewer rows, and their
    bf16 gradients are summed in fp32 across shards where one device
    sums every row in one product; the gaps seen on an H100 80GB HBM3 at
    700 W were 5.6e-5 and 1.46e-4), and the float32 master weights after
    step 1 within
    ``A6E_SHARD_UPDATE`` of one device's update: the worst leaf's
    ‖M_n − M_1‖ / ‖M_1 − M_0‖ (M_0 the initial weights, M_1 one device's
    after step 1) and | ‖M_n − M_0‖ / ‖M_1 − M_0‖ − 1 |, so that a
    skipped update (1.0 and 1.0) or a half one (0.5 and 0.5) fails; each
    shard's resident bytes, the
    split leaves' about 1/N of one device's. The restart across shard
    counts: the 2-shard state after step 1, gathered whole (a checkpoint's
    leaves) and cut onto 4 shards by the functions ``FSDPTrainer.restore``
    gives ``checkpoint.restore`` (``FSDPTrainer.place``), keeps every bit,
    and its step 2 agrees
    with the 2-shard run's within the same limits. (On disk at full width
    the checkpoint would hold 17 GB; ``tests/test_torch_sharding.py``
    restores from disk onto 1 and 4 shards.)"""
    import dataclasses as dc
    import numpy as np
    from repro_torch import configs
    from repro_torch.data import DataConfig, synthetic_lm_batch
    from repro_torch.distributed import make_mesh
    from repro_torch.kernels import ops
    from repro_torch.models import ModelOptions, count_params, init_params
    from repro_torch.train import OptConfig, TrainConfig, make_train_step
    from repro_torch.train.fsdp import FSDPTrainer
    from repro_torch.tree import leaves
    cfg = dc.replace(configs.get_arch(A6E_ARCH), n_layers=A6E_SHARD_LAYERS)
    opts = ModelOptions(dtype=torch.bfloat16, remat=True,
                        max_abs_pos=max(4096, TRAIN_SEQ))
    tcfg = TrainConfig(opt=OptConfig(lr=TRAIN_LR, warmup_steps=10,
                                     decay_steps=A6E_SHARD_STEPS))
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                      global_batch=TRAIN_BATCH)
    batches = [{k: torch.as_tensor(v, device=DEV) for k, v in
                synthetic_lm_batch(dcfg, i).items()}
               for i in range(A6E_SHARD_STEPS)]

    def fresh():
        return init_params(cfg, torch.Generator(device=DEV).manual_seed(0),
                           opts, device=DEV)

    init, step = make_train_step(cfg, tcfg, opts)
    params = fresh()
    n_params = count_params(params)
    state = init(params)
    one_bytes = (sum(x.numel() * x.element_size() for x in leaves(params)),
                 sum(x.numel() * x.element_size() for x in leaves(state)))
    m0 = [x.clone() for x in leaves(params)]     # bf16: M_0 is their value
    ref, t0 = [], time.perf_counter()
    for i, b in enumerate(batches):
        params, state, m = step(params, state, b)
        ref.append((float(m["loss"]), float(m["grad_norm"])))
        if i == 0:
            m1 = [x.clone() for x in leaves(state["master"])]
    torch.cuda.synchronize()
    t_one = time.perf_counter() - t0
    del params, state
    torch.cuda.empty_cache()
    out = dict(layers=A6E_SHARD_LAYERS, params=n_params, one_device=ref,
               one_device_s=t_one, one_device_bytes=one_bytes)

    def agree(what, got, want):
        for (lg, ng), (lw, nw) in zip(got, want):
            check(abs(lg - lw) <= 3e-4 * abs(lw)
                  and abs(ng - nw) <= 1e-3 * abs(nw),
                  f"{what}: loss / grad norm {lg} / {ng} vs {lw} / {nw}")

    def update_gap(masters) -> tuple:
        """Of gathered float32 master weights M_n after step 1, the worst
        leaf's ‖M_n − M_1‖ / ‖M_1 − M_0‖, | ‖M_n − M_0‖ / ‖M_1 − M_0‖ − 1 |
        and ‖M_n − M_1‖ / ‖M_1‖."""
        worst_up = worst_len = worst_ref = 0.0
        for a, w, w0 in zip(leaves(masters), m1, m0):
            gap = float((a - w).norm())
            upd = max(float((w - w0.float()).norm()), 1e-30)
            worst_up = max(worst_up, gap / upd)
            worst_len = max(worst_len, abs(float(
                (a - w0.float()).norm()) / upd - 1.0))
            worst_ref = max(worst_ref, gap / max(float(w.norm()), 1e-30))
        return worst_up, worst_len, worst_ref

    keep = None          # the 2-shard state after step 1 (the restart's)
    for n in (2, 4):
        mesh = make_mesh((n,), ("data",), devices=[DEV] * n)
        tr = FSDPTrainer(cfg, tcfg, opts, mesh)
        local, states = tr.init(fresh())
        res = tr.resident_bytes(local, states)
        path = f"a6e_sharded_{n}"
        begin_path(ops, path)
        got, t0 = [], time.perf_counter()
        for i, b in enumerate(batches):
            local, states, m = tr.step(local, states, b)
            got.append((float(m["loss"]), float(m["grad_norm"])))
            if i == 0:
                masters = tr.gather([x["master"] for x in states],
                                    first=True)[0]
                up, length, rel = update_gap(masters)
                del masters
            if n == 2 and i == 0:
                keep = (tr.gather(local, first=True)[0],
                        tr.gather(states, tr.state_specs(states),
                                  first=True)[0])
        torch.cuda.synchronize()
        t_n = time.perf_counter() - t0
        counts = launches[path] = end_path(ops)
        want_f = cfg.n_layers * 2 * n * A6E_SHARD_STEPS
        check(counts["flash_attention"] == want_f
              and counts["flash_attention_bwd"] == want_f // 2,
              f"{n}-shard training: launches {counts}, expected K-F {want_f}"
              f" / K-B {want_f // 2}")
        agree(f"{n} shards vs one device", got, ref)
        check(up <= A6E_SHARD_UPDATE[0] and length <= A6E_SHARD_UPDATE[1],
              f"{n} shards: master weights after step 1 {up:.4f} of one "
              f"device's update off, their update's length {length:.4f} "
              f"off its (worst leaves)")
        # the split leaves: each shard holds 1/n of them
        split = sum(x.numel() * x.element_size() for x, sp in zip(
            leaves(local[0]), _spec_leaves(tr.specs)) if "data" in sp)
        whole = sum(x.numel() * x.element_size() for x, sp in zip(
            leaves(local[0]), _spec_leaves(tr.specs)) if "data" not in sp)
        check(split * n + whole == one_bytes[0]
              and whole < 0.01 * one_bytes[0],
              f"{n} shards: resident parameter bytes {split} split + {whole} "
              f"whole against one device's {one_bytes[0]}")
        print(f"[{card}] FSDP training over {n} simulated shards "
              f"({A6E_ARCH} at full width, {A6E_SHARD_LAYERS} of 28 layers, "
              f"{n_params} parameters, bf16, AdamW, remat, batch "
              f"{TRAIN_BATCH} x {TRAIN_SEQ}): loss / grad norm "
              + "; ".join(f"{a:.5f} / {b:.4f}" for a, b in got)
              + " (one device: " + "; ".join(f"{a:.5f} / {b:.4f}"
                                             for a, b in ref)
              + f"); master weights after step 1 vs one device's: worst "
              f"leaf ||dM|| / ||update|| {up:.4e} (limit "
              f"{A6E_SHARD_UPDATE[0]}), | ||update_n|| / ||update|| - 1 | "
              f"{length:.4e} (limit {A6E_SHARD_UPDATE[1]}), ||dM|| / ||M|| "
              f"{rel:.4e}"
              f"; {t_n:.3f} s for {A6E_SHARD_STEPS} steps (one device "
              f"{t_one:.3f} s); resident bytes a shard (parameters / "
              f"optimizer state) " + ", ".join(f"{p} / {o}" for p, o in res)
              + f", one device {one_bytes[0]} / {one_bytes[1]}; of a "
              f"shard's parameters {split} bytes are its 1/{n} of the split "
              f"leaves and {whole} whole; launches {counts}", flush=True)
        out[f"shards_{n}"] = dict(steps=got, s=t_n, resident_bytes=res,
                                  launches=counts, master_gap_update=up,
                                  master_update_length=length,
                                  master_gap_rel=rel)
        if n == 2:
            cont = got[1]
        del local, states, tr
        torch.cuda.empty_cache()
    del m0, m1
    # the restart of the 2-shard state after step 1 onto 4 shards
    full_p, full_o = keep
    del keep
    tr = FSDPTrainer(cfg, tcfg, opts, make_mesh((4,), ("data",),
                                                devices=[DEV] * 4))
    local, states = tr.place(full_p, full_o)
    same = all(torch.equal(a, b) for a, b in zip(leaves(tr.gather(
        local, first=True)[0]), leaves(full_p))) and all(
        torch.equal(a, b) for a, b in zip(leaves(tr.gather(
            states, tr.state_specs(states[0]), first=True)[0]),
            leaves(full_o)))
    check(same, "restart onto 4 shards: the parts do not rebuild the "
          "2-shard state")
    del full_p, full_o
    torch.cuda.empty_cache()
    local, states, m = tr.step(local, states, batches[1])
    again = (float(m["loss"]), float(m["grad_norm"]))
    agree("2 shards restarted onto 4 vs 2 shards", [again], [cont])
    print(f"[{card}] restart of the 2-shard state after step 1 onto 4 "
          f"shards: every part rebuilds it bit for bit; step 2 loss / grad "
          f"norm {again[0]:.5f} / {again[1]:.4f} (2 shards: {cont[0]:.5f} "
          f"/ {cont[1]:.4f})", flush=True)
    out["restart_2_to_4"] = dict(step2=again, two_shards=cont)
    del local, states, tr
    torch.cuda.empty_cache()
    return out


def _spec_leaves(specs) -> list:
    """The placements of a spec tree in the order of its tree's leaves."""
    if isinstance(specs, dict):
        return [x for v in specs.values() for x in _spec_leaves(v)]
    if isinstance(specs, list):
        return [x for v in specs for x in _spec_leaves(v)]
    return [specs]


def phase_a6e(card, torch, rt, launches) -> tuple:
    """22. Queue A6e on the card: (a) K-F with the logit softcap in its
    tensor-core and split-KV forms and the read-only decode (a second key
    source), K-B with the cap on its bf16 route, each against its plain
    version (``a6e_kernel_cases``); (b) the capped reduced model card vs
    CPU (``reduced_capped``); (c) llama3.2-3b with cap 50 at full width
    and depth served through ``BatchedServer`` + ``make_knn_hook`` over
    phase 14's keys (``serve_family``: phase 19's traffic, counted); (d)
    the uncapped llama3.2-3b's read-only cache over phase 14's first 8
    prompts against the written decode (``readonly_check``); (e) the
    capped model trained (``capped_training``); (f) the FSDP step over 2
    and 4 simulated shards against one device, and a restart from 2 onto
    4 (``sharded_training``). Returns (K-F's cases, K-B's cases, the
    phase's numbers)."""
    import dataclasses as dc
    import numpy as np
    from repro_torch import configs
    from repro_torch.models import ModelOptions, init_params
    from repro_torch.serve import Datastore, KnnLMConfig
    t_phase = time.perf_counter()
    kf_cases, kb_cases = a6e_kernel_cases(card, torch)
    out = dict(reduced=reduced_capped(card, torch))
    base = configs.get_arch(A6E_ARCH)
    capped = dc.replace(base, attn_logit_softcap=A6E_CAP)
    rng = np.random.default_rng(14)          # phase 14's keys and prompts
    keys = rng.standard_normal((LM_STORE_KEYS, LM_STORE_DIM),
                               dtype=np.float32)
    vals = rng.integers(0, base.vocab, LM_STORE_KEYS).astype(np.int32)
    prompts = [rng.integers(0, base.vocab, int(rng.integers(
        LM_PROMPT[0], LM_PROMPT[1] + 1))).astype(np.int32)
        for _ in range(LM_REQUESTS)]
    store = Datastore.build(keys, vals, k=8, n_pivots=128, n_groups=8,
                            device=DEV)
    out["capped_serve"] = serve_family(
        card, torch, A6E_ARCH, store, keys, KnnLMConfig(lam=0.2, tau=50.0,
                                                        k=8),
        launches, cfg=capped, path="a6e_capped_serve",
        prompts=prompts[:FAM_REQUESTS])
    del store, keys
    torch.cuda.empty_cache()
    opts = ModelOptions(dtype=torch.bfloat16)
    params = init_params(base, torch.Generator(device=DEV).manual_seed(0),
                         opts, device=DEV)
    out["readonly"] = readonly_check(card, torch, base, params, opts,
                                     prompts[:LM_BATCH], A6E_ARCH,
                                     "a6e_readonly", launches)
    del params
    torch.cuda.empty_cache()
    out["capped_train"] = capped_training(card, torch, capped, launches)
    out["sharded"] = sharded_training(card, torch, launches)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[{card}] phase 22 (softcap, read-only cache, mesh layout) "
          f"{out['phase_s']:.3f} s", flush=True)
    return kf_cases, kb_cases, out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(ROOT / "build" / "chip_smoke"),
                    help="directory for long reports (ptxas output)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SmokeFailure("no CUDA device available")
    if not (ROOT / "src" / "repro_torch" / "__init__.py").is_file():
        raise SmokeFailure(f"the port's package is not beside this script "
                           f"({ROOT / 'src' / 'repro_torch'}): run it from "
                           f"a checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch as rt
    from repro_torch.kernels import assign as ka
    from repro_torch.kernels import build, ops

    # the plain versions' matrix products in full fp32, stated explicitly
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 1. card, versions, build
    card = card_line()
    print(f"[{card}] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.perf_counter()
    reports = build.build()
    build_s = time.perf_counter() - t0
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "ptxas.txt").write_text(
        "".join(f"== {n}\n{r}\n" for n, r in reports.items()))
    print(f"[{card}] built {sorted(reports) or 'nothing (cached)'} in "
          f"{build_s:.2f} s (ptxas report: {out_dir / 'ptxas.txt'})",
          flush=True)
    ASSIGN_PTXAS.update(ptxas_usage(reports.get("assign", "")))
    print(f"[{card}] K-A kernels (registers, spill bytes): "
          + (", ".join(f"{k} {v[0]}, {v[1]}" for k, v in ASSIGN_PTXAS.items())
             or "not rebuilt"), flush=True)
    record_assign_shapes(ka)

    cfg = rt.JoinConfig(k=10, n_pivots=256, tile_r=128, tile_s=512)
    s_np = rt.forest_like(N_ROWS, DIM, seed=0)
    r_np = rt.forest_like(N_ROWS, DIM, seed=1)

    # ---- 2, 3. each kernel against its plain version
    s_dev = torch.as_tensor(s_np, device=DEV)
    pivots = torch.as_tensor(rt.core.select_pivots(
        s_np, cfg.n_pivots, cfg.pivot_strategy, sample=cfg.pivot_sample,
        n_sets=cfg.pivot_candidate_sets, seed=cfg.seed, device=DEV),
        device=DEV)
    g_row, g_forest = phase_gather(card, torch, rt, s_np, r_np, cfg)
    rows = [phase_assign(card, torch, rt, s_dev, pivots), g_row]

    # ---- 4. the serving path, counted
    begin_path(ops, "megastep")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    idx = rt.build_index(s_np, cfg, device=DEV)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = rt.knn_join_batched(r_np, index=idx, batch_size=BUCKET,
                              megastep=True, device=DEV)
    t_join = time.perf_counter() - t0
    launches = {"megastep": end_path(ops)}
    steps = res.stats.n_batches
    print(f"[{card}] slice: build_index {t_build:.3f} s, join {t_join:.3f} s "
          f"over {N_ROWS} queries = {N_ROWS / t_join:.1f} queries/s, "
          f"{steps} megasteps, launches {launches['megastep']}; exact "
          f"re-runs of uncertified K-G runs (C15) {res.stats.n_exact_rerun} "
          f"({res.stats.n_exact_rerun / N_ROWS:.6f})", flush=True)
    check(launches["megastep"]["assign"] > 0
          and launches["megastep"]["distance_topk_gather"] > 0,
          f"a kernel of the megastep path was never launched: "
          f"{launches['megastep']}")

    # ---- 5. against the float64 brute force, tie-aware
    check_exact(card, rt, "megastep join", r_np, s_np, res.distances,
                res.indices, cfg.k)

    # ---- 6. steady state: no host sync between enqueue and fetch
    eng = rt.StreamJoinEngine(idx, cfg, megastep=True,
                              device=DEV).megastep_engine
    qd, nv = eng.enqueue(r_np[:BUCKET])
    warm = eng.join_batch_device(qd, nv)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = eng.join_batch_device(qd, nv)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    check(torch.equal(out[0], warm[0]) and torch.equal(out[1], warm[1]),
          "steady state: repeated megastep differs")
    step_ms = time_ms(lambda: eng.join_batch_device(qd, nv), iters=10)
    print(f"[{card}] steady-state join_batch_device: no host sync under "
          f"set_sync_debug_mode('error'); {step_ms:.4f} ms per "
          f"{BUCKET}-query megastep", flush=True)
    profile_device(card, torch, lambda: eng.join_batch_device(qd, nv),
                   f"steady-state megastep (per step, {BUCKET} queries)",
                   out_dir / "megastep_profile.txt", runs=5)
    n_prof = 32 * BUCKET
    profile_device(card, torch, lambda: rt.knn_join_batched(
        r_np[:n_prof], index=idx, batch_size=BUCKET, megastep=True,
        device=DEV), f"knn_join_batched ({n_prof} queries, 32 batches)",
        out_dir / "join_profile.txt")

    # ---- 7. K-Q against its plain version. An explicit shortlist slack
    # pins the engine to int8 (no tuning-table cell can bypass K-Q):
    # mp = pow2(k + 118) = 128, the auto value at k = 10
    from repro_torch.quant import autotune
    cells = {key: val for key, val in autotune.default_table()
             .entries.items() if key.startswith("cuda|")}
    print(f"[{card}] quant tuning table ({autotune.default_table_path()}, "
          f"tools/tune_quant.py; every counted int8 path pins int8 with "
          f"quant_slack): " + ("; ".join(
              f"{key} {val.mode} mp {val.mp or '-'}, int8 "
              f"{val.int8_batch_s * 1e3:.3f} ms, fp32 "
              f"{val.fp32_batch_s * 1e3:.3f} ms a 256-query batch"
              for key, val in sorted(cells.items())) or "no cuda cell"),
          flush=True)
    cfg_q = dataclasses.replace(cfg, quant_slack=118, reducer="gather")
    t0 = time.perf_counter()
    idx_q = rt.build_index(s_np, cfg_q, quantize="int8", device=DEV)
    torch.cuda.synchronize()
    t_build_q = time.perf_counter() - t0
    rows.append(phase_quant(card, torch, rt, idx_q, r_np, cfg_q))

    # ---- 8. the quantized path, counted
    begin_path(ops, "quantized")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    idx_q = rt.build_index(s_np, cfg_q, quantize="int8", device=DEV)
    res_q = rt.knn_join_batched(r_np, index=idx_q, batch_size=BUCKET,
                                quantized=True, device=DEV)
    t_quant = time.perf_counter() - t0
    launches["quantized"] = end_path(ops)
    st = res_q.stats
    print(f"[{card}] quantized path: build_index(int8) "
          f"{t_build_q:.3f} s alone; build + join {t_quant:.3f} s over "
          f"{N_ROWS} queries = {N_ROWS / t_quant:.1f} queries/s, "
          f"{st.n_batches} steps, mode {st.quant_mode}, mp {st.quant_mp}, "
          f"resident re-rank {st.n_resident_rerank}, host re-rank "
          f"{st.n_host_rerank}, certification fallbacks "
          f"{st.n_quant_fallback} ({st.n_quant_fallback / N_ROWS:.4%}), "
          f"resident bytes int8 {idx_q.nbytes_resident()} vs fp32 "
          f"{idx_q.nbytes_resident(quantized=False)}, launches "
          f"{launches['quantized']}", flush=True)
    check(st.quant_mode == "int8"
          and launches["quantized"]["quant_coarse_gather"] > 0,
          f"the quantized path did not run K-Q: {launches['quantized']}")
    check(st.n_quant_fallback == 0
          or launches["quantized"]["distance_topk_gather"] > 0,
          "certification fallbacks did not run the host path's K-G")
    check_exact(card, rt, "quantized join", r_np, s_np, res_q.distances,
                res_q.indices, cfg.k)
    check_same_distances("quantized join vs megastep", res_q.distances,
                         res.distances, res_q.indices, res.indices, r_np,
                         s_np)
    qeng = rt.QuantMegastepEngine(idx_q, cfg_q, device=DEV)
    check(qeng.resident, "quant engine: expected the resident re-rank")
    qd, nv = qeng.enqueue(r_np[:BUCKET])
    warm = qeng.join_batch_device(qd, nv)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = qeng.join_batch_device(qd, nv)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(out, warm)),
          "quant steady state: repeated step differs")
    qstep_ms = time_ms(lambda: qeng.join_batch_device(qd, nv), iters=10)
    print(f"[{card}] steady-state quant join_batch_device: no host sync "
          f"under set_sync_debug_mode('error'); {qstep_ms:.4f} ms per "
          f"{BUCKET}-query step (fp32 megastep {step_ms:.4f} ms)",
          flush=True)
    profile_device(card, torch, lambda: qeng.join_batch_device(qd, nv),
                   f"steady-state quant step (per step, {BUCKET} queries)",
                   out_dir / "quant_profile.txt", runs=5)
    profile_device(card, torch, lambda: rt.knn_join_batched(
        r_np[:n_prof], index=idx_q, batch_size=BUCKET, quantized=True,
        device=DEV), f"quantized knn_join_batched ({n_prof} queries, 32 "
        f"batches)", out_dir / "quant_join_profile.txt")

    # ---- 9. the host-planned path: the paper's one-shot pipeline, pivots
    # from R, on a sample of R
    cfg_h = dataclasses.replace(cfg, n_groups=8, reducer="gather")
    r_h = r_np[:HOST_ROWS]
    begin_path(ops, "host_planned")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plan = rt.core.plan_join(r_h, s_np, cfg_h, device=DEV)
    res_h = rt.knn_join(r_h, plan=plan, device=DEV)
    t_host = time.perf_counter() - t0
    launches["host_planned"] = end_path(ops)
    st = res_h.stats
    print(f"[{card}] host-planned knn_join (gather reducer, pivots from R) "
          f"over {HOST_ROWS} queries: {t_host:.3f} s with planning = "
          f"{HOST_ROWS / t_host:.1f} queries/s, replicas "
          f"{st.replicas_s}, tile selectivity {st.tile_selectivity:.4f}, "
          f"exact re-runs (C15) {st.n_exact_rerun}, "
          f"launches {launches['host_planned']}", flush=True)
    check(launches["host_planned"]["assign"] > 0
          and launches["host_planned"]["distance_topk_gather"] > 0,
          f"a kernel of the host path was never launched: "
          f"{launches['host_planned']}")
    check_exact(card, rt, "host-planned join (gather)", r_h, s_np,
                res_h.distances, res_h.indices, cfg.k)
    mega_h = rt.knn_join(r_h, index=plan.index, megastep=True, device=DEV)
    check_same_distances("host-planned join vs megastep", res_h.distances,
                         mega_h.distances, res_h.indices, mega_h.indices,
                         r_h, s_np)
    for reducer, n in (("pruned", PRUNED_ROWS), ("dense", DENSE_ROWS)):
        t0 = time.perf_counter()
        got = rt.knn_join(r_h[:n], index=plan.index,
                          config=dataclasses.replace(cfg_h, reducer=reducer),
                          device=DEV)
        wall = time.perf_counter() - t0
        print(f"[{card}] host-planned knn_join ({reducer} reducer) over {n} "
              f"queries: {wall:.3f} s", flush=True)
        check_exact(card, rt, f"host-planned join ({reducer})", r_h[:n],
                    s_np, got.distances, got.indices, cfg.k)
        check_same_distances(f"{reducer} reducer vs megastep",
                             got.distances, mega_h.distances[:n],
                             got.indices, mega_h.indices[:n], r_h[:n],
                             s_np)

    # ---- 10. K-D against its plain version (retrieval and LM shapes)
    rows.append(phase_dense(card, torch, rt, s_np, r_np))

    # ---- 11. the mutable index: 16 segments, tombstones, compaction
    phase_mutable(card, torch, rt, s_np, r_np, cfg, launches, out_dir)

    # ---- 12. kNN-LM retrieval through both knn_logits routes
    phase_retrieval(card, torch, rt, s_np, r_np, launches)

    # ---- 13. the shapes the kernels refused before
    caps = phase_caps(card, torch, rt, s_np, r_np, cfg, g_forest)
    del g_forest
    torch.cuda.empty_cache()

    # ---- 14. the LM serving path at full width
    rows.append(phase_lm(card, torch, rt, launches, out_dir))

    # ---- 15. K-A at the other shapes the counted paths handed it
    assign_paths = phase_assign_paths(card, torch, rt)

    # ---- 16. the paper's §6 comparison: PGBJ, PBJ, H-BRJ, L1 / L∞
    paper = phase_paper(card, torch, rt, launches)

    # ---- 17. serving under load through the deadline-aware scheduler
    serving = phase_serving(card, torch, rt, idx_q, cfg_q, r_np, s_np,
                            res.distances, launches)
    (out_dir / "phases_16_17.json").write_text(json.dumps(
        {"paper_three_way": paper, "serving_under_load": serving}))

    # ---- 18. the mesh: sharded megastep, int8 tier, datastore, shuffle
    mesh = phase_mesh(card, torch, rt, launches, s_np=s_np, r_np=r_np,
                      cfg=cfg, idx=idx, res=res, idx_q=idx_q, cfg_q=cfg_q,
                      res_q=res_q, pivots=pivots, paper=paper)
    (out_dir / "phase_18.json").write_text(json.dumps(mesh))
    mesh_paths = [p for p in launches if p.startswith("mesh_")]
    for name in ("assign", "distance_topk_gather", "quant_coarse_gather",
                 "distance_topk"):
        check(sum(launches[p][name] for p in mesh_paths) > 0,
              f"the mesh paths never launched {name}")

    # ---- 19. the MoE family: MLA on K-F, the MoE FFN, at full width
    mla_cases, moe_run = phase_moe(card, torch, rt, launches)
    (out_dir / "phase_19.json").write_text(json.dumps(
        dict(moe_run, kf_cases=mla_cases)))

    # ---- 20. the recurrent, hybrid, audio and VLM families at full width
    fam_cases, fam_run = phase_families(card, torch, rt, launches)
    (out_dir / "phase_20.json").write_text(json.dumps(
        dict(fam_run, kf_cases=fam_cases)))

    # ---- 21. the train path: K-B, K-F with lse, llama3.2-3b trained
    kb_cases, train_run = phase_training(card, torch, launches, out_dir)
    (out_dir / "phase_21.json").write_text(json.dumps(train_run))
    # ---- 22. A6e: the softcap, the read-only cache, the mesh layout
    a6e_kf, a6e_kb, a6e_run = phase_a6e(card, torch, rt, launches)
    (out_dir / "phase_22.json").write_text(json.dumps(a6e_run))
    kb_row = dict(name="flash_attention_bwd", route="cuda",
                  source="src/repro_torch/csrc/flash_attn_bwd.cu",
                  replaces="src/repro/models/layers.py:130 (jax.grad of "
                           "_sdpa; the JAX package has no Pallas backward)")
    kb_row.update({key: kb_cases[0][key] for key in _ROW_KEYS})
    kb_row["other_shapes"] = kb_cases[1:] + a6e_kb
    rows.append(kb_row)

    owner = {"assign": ("megastep",), "distance_topk_gather": ("megastep",),
             "quant_coarse_gather": ("quantized",),
             "distance_topk": ("retrieval",),
             "flash_attention": ("lm_serve", "moe_serve", "moe_arctic",
                                 "moe_readonly", "fam_recurrentgemma",
                                 "fam_xlstm", "fam_qwen2",
                                 "fam_qwen2_vision", "fam_whisper", "train",
                                 "a6e_capped_serve", "a6e_readonly",
                                 "a6e_capped_train", "a6e_sharded_2",
                                 "a6e_sharded_4"),
             "flash_attention_bwd": ("train", "a6e_capped_train",
                                     "a6e_sharded_2", "a6e_sharded_4")}
    for row in rows:
        if row["name"] in caps:
            row["cap_shapes"] = caps[row["name"]]
        if row["name"] == "assign":
            row["path_shapes"] = assign_paths
        if row["name"] == "flash_attention":
            row["other_shapes"] += mla_cases + fam_cases + a6e_kf
        # the main paths' launches, plus the mesh paths' (phase 18)
        row["launches"] = sum(launches[p][row["name"]]
                              for p in owner[row["name"]] + tuple(mesh_paths))
        row["launches_by_path"] = {path: n[row["name"]]
                                   for path, n in launches.items()}
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        for stream in (sys.stdout, sys.stderr):
            print(f"chip_smoke: FAILED: {e}", file=stream, flush=True)
        sys.exit(1)
