#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases, each of which fails the run on any error:

* build: compiles the seven CUDA kernels from ``src/repro_torch/kernels/
  csrc`` with ``nvcc`` (one process per source, in parallel);
* K: every kernel against its plain PyTorch version on the card at the
  main path's shapes (the RAR tiers, the embedder, llama3-8b, the guide
  store at 4096 and 65536 rows and the single-query IVF read's 256
  gathered rows, the IVF centroid planes, the IVF candidate read on Phase
  I2's store), with its time, the plain version's, a PyTorch library
  call's and the bound; for the store reads at k = 1 (top-1: the full
  view), the IVF route and candidate read and the attention kernels at
  llama3-8b also the kernel's and the library call's device time a call
  (``torch.profiler``) and time with the L2 flushed; and the split-KV
  decode's own cases (caches of 1024 and 4096, cache_len per row, an
  empty cache, and the ring read: a 4096-slot ring past its wrap, with
  and without a window); the attention kernels at every Phase Z model's
  shapes (head widths 64, 96, 128 and 256, whisper's non-causal encoder
  over 1500 frames and its cross reads, f32 at 96 and 256); the ptxas
  report of the attention kernels (registers and spills) after the
  build;
* E (after K): the dropless MoE's grouped expert products
  (``csrc/moe_grouped.cu``) against their plain versions at the
  olmoe.answer.azcode cell's call shapes (B x S = 10 x 1,536 and 4 x
  4,096, OLMoE's widths, bf16), with one expert in every token's top k,
  on skewed groups (half the slots in one expert, 20 experts empty) and at
  a decode step (S = 1); the grouped layer against the buffer path within
  two bf16 roundings, under sync debug mode "error"; each product's time
  beside its bound and the buffer path's batched products; one traced
  OLMoE call with its four ``moe.*`` spans and ``moe.grouped`` once a
  layer;
* R: ``MicrobatchRAR`` serving the ``rar_throughput`` workload (pool 64,
  2 passes, microbatch 8 and 32) on the card and on the CPU in the same
  process, with identical Outcome streams, FM calls and stores required
  (R1: precomputed hash embeddings; R2: the port's embedder on the card);
* I: the IVF retrieval plane. I1 serves R1's workload with 64 clusters
  probed in full (it must give R1's Outcome streams: 192 strong calls);
  I2 serves it against a 65536 x 384 store of clustered rows with 1024
  clusters and 4 probes, and measures recall@4 and the IVF read against
  the exact scan (CUDA-event and device time); I3 holds ``memory.query``/
  ``query_batch`` (the top-1 kernel) on that store. Card and CPU must
  agree in every step;
* L: ``ServingEngine.generate_bucketed`` at the full width of llama3-8b
  (bf16, random weights from a seed) serving 8 mixed-length requests;
* Z (after L): the model zoo at full width, one model at a time, freed
  between, random weights from a seed (bf16). Z1: olmoe-1b-7b (16 layers,
  64 experts top-8) and Z2: granite-moe-3b-a800m, olmo-1b, gemma3-27b (one
  1300-token prompt, past its 1024-token local windows),
  deepseek-coder-33b, mamba2-2.7b (prompts of 17 and 600 tokens: 600 pads
  to three 256-token SSD chunks), recurrentgemma-2b (17, 130 and 2100
  tokens, past its 2048-token window), phi-3-vision-4.2b (256 seeded
  patch embeddings before each prompt) and whisper-medium (1500 seeded
  frames for its encoder), each at full depth, serve prompts through
  ``ServingEngine.generate_bucketed`` (``generate`` with the frontend
  input for phi-3-vision and whisper) (ms/request, tokens/s, peak memory,
  the card's busy share under the profiler; flash and decode must launch,
  and neither in mamba2-2.7b, whose path has no attention), and the
  kernel path's prefill and first decode-step logits are held to
  ``forward`` (``layers.attention``) on the card within Z_TOL of the
  largest logit, argmax equal where the top-2 margin exceeds it. Z3:
  the ring KV cache, olmoe-1b-7b with a 256-slot ring over 300 decode
  steps and gemma3-27b cut to 6 layers (one 5:1 group) with a 1024-slot
  ring over 1100, B = 2, every step's logits equal to the full cache's at
  the same ``decode_window`` (rtol = atol = 2e-4), through the decode
  kernel in ring mode;
* T (after Z): the zoo trainer (``repro_torch.launch.train.train``) on
  the card. T1: olmo-1b at full width and depth (bf16, batch 4 x 1024, 6
  steps): every loss finite, the last below the first, the checkpoint
  reloaded bit for bit and served (Phase Z's serving run and logit checks
  on the trained weights, prompts of 17 and 130 tokens: flash and decode
  launch). T2: whisper-medium at full width and depth (batch 2 x 448, 1500
  frames, 4 steps): losses finite and falling. Both: ms/step, tokens/s,
  peak memory and the card's busy share. T3: every arch's smoke config, 3
  steps on the card and on the CPU from one init, every step's loss within
  T3_TOL relative;
* D (after T): the dry run on this machine's torch, ``python -m
  repro_torch.launch.dryrun`` for the six pairs of ``tests/test_dryrun.py``
  (a process each, side by side, the card hidden): each ``ok`` (whisper-
  medium ``train_4k``, which the JAX package fails, ``ok`` or ``FAILED`` as
  ROADMAP.md records), with its compute, memory and collective terms, the
  dominant one and its arguments per device against 80 GB;
* S: the trained system on the card. S0 runs 5 train steps of rar-weak
  (AdamW) and of the embedder (Adam) from one init on the card and on the
  CPU (losses within 1e-4 relative, parameters within 1e-4 of the
  distance trained); S1 trains the whole system with ``build_system`` on
  the card at the JAX package's defaults (900 / 1100 / 400 steps, batch
  96, 600 profiled prompts for the router) and prints each part's time,
  loss and accuracy; S2 checks ``tests/test_system.py``'s premise on it;
  S3 copies it to the CPU and requires equal failing pools,
  ``StageResult`` s (``run_rar_experiment`` at microbatch 1 and 16 with
  the oracle router, 16 with the learned one, pool 120, 3 stages) and
  baselines on both devices, then the twin's claims on the card's run;
  S4 runs the fig4 shape on the card (the 754-question pool, 5 stages,
  microbatch 16, one shuffle) and prints its numbers beside the paper's;
* P (last, after F5): the JAX package's own fig4/fig7 runs, recorded on
  the CPU by ``scripts/export_jax_reference.py`` with the weights they ran
  on (``reference/``). The exported system is bridged onto the card, and
  the card must give the record's failing pool (P1, 754 questions),
  ``run_baselines`` rows (P2), and every ``StageResult`` of the four
  sequential runs (P3: seeds 0 and 1 at ``retrieval_k`` 1 and 4, 5 stages)
  and of the microbatch-16 runs (P4: the S4 shape, and the pool's first
  120 at ``retrieval_k=4`` over 2 stages). A mismatch prints the run, its
  first differing stage, both rows and the pool's margins (the card's
  beside the record's) and fails the phase. fig4's ratios and fig7's split
  print beside the record's and the paper's, with each run's requests/s;
  ``memory_topk`` must launch at B = 1, B = 16 and k = 4, flash and decode
  at all;
* G (after P, on P's system): the JAX package's own runs of the paper's
  fig6 (domain 1, 359 questions) and fig5 (domain 2, 675) and of its Table
  I, recorded on the CPU by ``scripts/export_jax_domains.py``. For each
  domain the card must give the record's failing pool (G1; its margins
  beside the record's), baselines (G2) and every ``StageResult`` of the
  sequential run (G3: seed 0, k = 1, 5 stages) and of the microbatch-16
  run (G4: ``retrieval_k=4``); fig4's summary of G3 prints beside the
  record's. G5 runs Table I (``benchmarks/table1_generalization.py``'s
  procedure, twinned by :func:`table1`): a guide memory populated on domain
  0's 754-question pool and one on each target read by the target's
  questions (``memory.query(..., guides_only=True)``, the top-1 kernel at
  B = 1 with ``required`` = 3: 2,068 reads), each question's retrieved row,
  guided flag and weak answer equal to the record's and its similarity
  within G_SIM_TOL, the counts and percentages equal. Each run's
  requests/s prints beside the record's CPU rate, the store reads by
  (kernel, B, k, ``required``) at the end;
* A (after I; A4 after S): the shadow plane's drain modes and the
  journal on the card, on R1's workload at microbatch 8. A1: async with a
  barrier after every batch, deferred at flush-every 1 and adaptive under
  an always-drain policy each equal R1's inline run field for field (192
  strong calls), and the async drainer's memory_topk, flash and decode
  kernels launched on its own CUDA stream. A2: unbarriered async (with a
  drain delay) and adaptive, and deferred, at flush-every 4, journaled:
  the queue's invariants hold and the card store equals the journal
  replayed on the CPU; A2b the async leg on I1's IVF plane (its epochs'
  ops replayed on a CPU IVF store); requests/s by mode. A3: crashes at
  the WAL write and at the apply of an epoch; the journal reopened on the
  card gives the never-crashed store one epoch behind and at that epoch,
  and the recovered controller serves the rest of the stream to the
  never-crashed Outcomes. A4: ``repro_torch.launch.serve.main`` on Phase
  S's system, async and journaled, run twice on one journal: the restart
  starts from the first run's final store and the last manifest it
  journaled.
* F (after A; F5 after A4): the serving fabrics on R1's configuration and
  workload. F1: ``ServingFabric(replicas=1)``, synchronous, equals R1 at
  microbatch 8 and 32. F2: 2 and 4 thread replicas, one ticket at a time,
  equal R1; every ticket submitted at once keeps the fabric's invariants,
  inline and async at flush-every 4 (a drainer stream a replica). F3:
  ``ProcessServingFabric`` (spawned workers, a CUDA context each): 1 worker
  pipelined, 2 serialized, 2 with worker 1 SIGKILLed, and a whole-fabric
  kill rebuilt on its journal each equal R1; the workers' own launches of
  the store-read and flash kernels ride back in their "done" messages and
  must be above 0 (the serve plane runs no decode step: answers take one
  token, and the guides' decode steps run in the parent's drains). Rates: closed-loop requests/s of the thread
  fabric and the process fabric at 1/2/4 (3 fabrics each, spawn excluded)
  beside nvidia-smi's utilization. F4: a seeded Poisson trace of R1's
  requests on 2 streams through ``serve_trace``: two card runs give the same
  batches and Outcomes, the CPU the same Outcomes; paced runs at 50% and 90%
  of the 2-replica closed-loop rate print queue delay and end-to-end
  latency. F5: ``repro_torch.launch.serve.main`` on Phase S's system with
  two worker processes and Poisson arrivals answers every request.
* M (after F): the sharded guide store (``core/memory_sharded.py``),
  logical shards on the one card. M1: R1's configuration, workload and
  tiers on ``ShardedMemory`` at 2 and 4 shards (beside R1 again, warm, on
  one store) equal R1's card run field for field (192 strong calls,
  ``to_single_device`` the same store); async at flush-every 4 on 4 shards
  keeps Phase A2's queue invariants, holds min(ptr, C) valid rows and reads
  bit for bit as its ``to_single_device``.
  M2: the exact reads (``query``, ``query_batch``, top-k at k = 1 and 4,
  B = 32, both views) at E = 384 on stores of 65536 and 4,194,304 rows at
  1, 4, 8 and 16 shards are bit-identical to a single-device store that
  took the same commits (at 65536 also to the CPU's plain reads), with
  CUDA-event and device times beside the single-device read's and the
  bytes' bound. Z4 runs inside it: at 4,194,304 rows the single-device
  top-4 reads (B = 1 and 32) equal the kernel's plain version on the card
  bit for bit (the list mode's merge in two rounds), timed.
  M3: I2's setting on a 4-shard backing (the route merged from 4 planes)
  serves I2's Outcome stream, store and index, reads as I2's card and CPU
  reads bit for bit and has I2's recall@4; its read is timed beside I2's.
  M4: ``ServingFabric`` with 2 thread replicas, serialized, over one
  4-shard store equals R1.

The launch counters are zeroed right before each main-path phase (for S,
before S1; A1-A3 together, A4 alone, F1-F4 together, M1-M4 together, F5
alone, P alone, G alone, each of Z's serving and ring runs, T1's serving
run) and read right after it, a process fabric's workers' counts added, Phase M's
timed reads' and Phase Z's checks' launches taken out; a kernel of the
path that did not launch fails the run.
The last lines are the kernels' JSON, the card's name and power limit,
and ``{"ok": true, "device": ...}``.

:func:`trace` (not part of the run above) profiles the main paths (RAR
serving, the IVF plane, training steps, llama3-8b) and prints where the
card's time goes.
"""
from __future__ import annotations

import copy
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
F32_FLOPS = 67e12                # f32 outside the tensor cores
BF16_FLOPS = 989e12              # bf16 dense tensor-core peak
TOPK_TOL = 1e-6
ATTN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
SEEDS = {"weak": 0, "strong": 1, "embedder": 2, "llama": 3, "store": 4}
POOL, PASSES, MICROBATCHES, SEQ_LEN = 64, 2, (8, 32), 16
JAX_STRONG_CALLS = 192           # BENCH_rar_throughput.json, per 128
LLAMA_LENGTHS = (17, 45, 64, 96, 130, 180, 240, 300)
LLAMA_MAX_NEW = 8
DEV = "cuda"
LLAMA_CONFIG = "FULL"            # llama3_8b.FULL: all 32 layers
IVF_EXACT = (64, 64)             # I1: clusters, probes (all: exact)
IVF_STORE = (65536, 1024, 4)     # I2: capacity, clusters, probes
S0_STEPS = 5
S0_LOSS_TOL = 1e-4               # relative, card against CPU
S0_PARAM_TOL = 1e-4              # relative, L2 over the whole tree
S3_POOL = 120                    # tests/test_system.py's pool
S3_RUNS = {"mb1": {}, "mb16": dict(microbatch=16),
           "mb16_learned": dict(microbatch=16, router_kind="learned")}
FIG4_STAGES, FIG4_MB = 5, 16
REFERENCE = ROOT / "reference"   # Phase P: the JAX package's record
G_DOMAINS = (1, 2)               # G: fig6 (HS psychology), fig5 (moral)
G_SIM_TOL = 1e-5                 # G5: a read's similarity against JAX's
T1_THRESHOLD = 0.1               # Table I: the transfer threshold
WAIT_S = 120.0                   # the longest any shadow barrier may take
A2_FLUSH, A2_DELAY = 4, 0.005    # A2: drain cadence and injected delay
A3_SNAPSHOT, A3_CRASH = 3, {"wal": 5, "apply": 8}   # A3: epochs
F_REPLICAS = (1, 2, 4)           # F: thread replicas, process workers
F_RUNS = 3                       # F: timed runs a configuration
F_ASYNC_FLUSH = 4                # F2: async drain cadence
F4_SEED, F4_RATE, F4_SLO_MS = 19, 400.0, 10.0   # F4: the open-loop trace
F4_LOADS = (0.5, 0.9)            # F4: paced runs, of F2's closed-loop rate
F5_REQUESTS = 64                 # F5: the launcher's pool
M1_SHARDS = (2, 4)               # M1: logical shards of R1's store
M2_CAPACITIES = (65536, 4_194_304)   # M2: stores of 384-lane rows
M2_SHARDS = (1, 4, 8, 16)        # M2: shards beside the single-device store
M2_COMMIT, M2_B = 65536, 32      # M2: rows a commit, queries a read
M3_SHARDS = 4                    # M3: I2's store on a sharded backing
Z_SEED, Z_MAX_NEW = 5, 8         # Z1/Z2: weights' seed, tokens a request
# Z1/Z2: (arch, prompt lengths, depth cut or None), one at a time, freed
# between; gemma3-27b's 1300 tokens run past its 1024-token local windows,
# mamba2-2.7b's 600 pad to three 256-token chunks, recurrentgemma-2b's
# 2100 run past its 2048-token window; phi-3-vision-4.2b's prompts follow
# its 256 patch embeddings, whisper-medium's go with 1500 frames
Z_MODELS = (("olmoe-1b-7b", (17, 130), None),
            ("granite-moe-3b-a800m", (17, 130), None),
            ("olmo-1b", (17, 130), None),
            ("gemma3-27b", (1300,), None),
            ("deepseek-coder-33b", (17, 130), None),
            ("mamba2-2.7b", (17, 600), None),
            ("recurrentgemma-2b", (17, 130, 2100), None),
            ("phi-3-vision-4.2b", (17, 130), None),
            ("whisper-medium", (17, 130), None))
# Z1/Z2: the kernel path's logits within Z_TOL x the largest reference
# logit of the training path's (both bf16 on the card; PERF.md, PR 21)
Z_TOL = 0.05
# T1/T2: (arch, steps, batch, seq) trained at full width and depth; T3:
# (steps, batch, seq) of every arch's smoke config, card against CPU
T1 = ("olmo-1b", 6, 4, 1024)
T1_PROMPTS = (17, 130)           # T1: served from the reloaded checkpoint
T2 = ("whisper-medium", 4, 2, 448)
T3 = (3, 4, 32)
T_LR, T3_TOL = 1e-3, 1e-4
# D: the dry-run pairs of tests/test_dryrun.py (arch, shape, multi-pod)
D_CASES = (("llama3-8b", "decode_32k", False),
           ("llama3-8b", "decode_32k", True),
           ("mamba2-2.7b", "long_500k", False),
           ("olmoe-1b-7b", "prefill_32k", False),
           ("recurrentgemma-2b", "decode_32k", False),
           ("whisper-medium", "train_4k", False))
D_TIMEOUT_S = 400
# E: the grouped MoE products at the olmoe.answer.azcode cell's call
# shapes (B, S) of 16,384 tokens, OLMoE's widths, and a decode step
E_SHAPES = ((10, 1536), (4, 4096), (2, 1))
E_WIDTHS = dict(D=2048, F=1024, E=64, k=8)
E_SEED = 29
# Z3: (arch, decode_window = ring slots, decode steps, B, depth cut)
Z_RINGS = (("olmoe-1b-7b", 256, 300, 2, None),
           ("gemma3-27b", 1024, 1100, 2, 6))


def log(*a):
    print(*a, flush=True)


def time_ms(torch, fn, iters=20, warmup=3):
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


def device_events(prof, path):
    """The card's kernels, copies and memsets in a finished
    ``torch.profiler`` run, read back from its chrome trace at ``path``."""
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    return [e for e in json.loads(path.read_text())["traceEvents"]
            if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]


def device_ms(torch, fn, tag, iters=20, tries=5):
    """Device time of one call of ``fn`` (all its kernels, copies and
    memsets) from ``torch.profiler`` over ``iters`` calls after a warm-up,
    and the kernel names seen; (None, []) if no profile of ``tries``
    caught device activity (CUPTI now and then delivers none), which is
    logged as not measured."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = device_events(prof, ROOT / "build" / "trace" /
                               f"k_{tag}.json")
        if events:
            break
        time.sleep(0.2)
    else:
        log(f"device time not measured ({tag}): torch.profiler saw no "
            f"device activity in {tries} profiles")
        return None, []
    names = sorted({e["name"].removeprefix("void ")[:40] for e in events})
    return sum(e["dur"] for e in events) / 1e3 / iters, names


def cold_ms(torch, fn, iters=20):
    """CUDA-event time of one call of ``fn`` with the L2 cache flushed
    before it: a 64 MB buffer is written and the stream held ~0.1 ms
    (``torch.cuda._sleep``) outside the timed window, so the call is
    queued before its start event fires and meets a cold L2, as each
    layer's cache does in a decode step behind the weight stream."""
    flush = torch.empty(16 * 2 ** 20, dtype=torch.float32, device=DEV)
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(200_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def card_line() -> str:
    """The first card's name and power limit, as ``nvidia-smi`` gives
    them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def bound(bytes_moved, flops, rate):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# Phase K: kernels against their plain versions
# ---------------------------------------------------------------------------


def phase_k(torch):
    import numpy as np
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import memory_ivf as ivf
    from repro_torch.kernels import memory_topk as mt
    from repro_torch.kernels import ops

    dev = torch.device(DEV)
    rng = np.random.default_rng(0)
    rows = {}

    def record(name, key, err, ms, plain_ms, lib_ms, b, **extra):
        more = "".join(f" {k}={v:.4f}" if isinstance(v, float) else
                       f" {k}={v}" for k, v in extra.items())
        log(f"K {name} {key}: max_abs_err={err:.3e} ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
            f"bound_ms={b[0]:.5f} ({b[1]}){more}")
        rows.setdefault(name, []).append(
            dict(key=key, err=err, ms=ms, plain_ms=plain_ms,
                 library_ms=lib_ms, bound_ms=b[0], bound_by=b[1], **extra))

    def card_times(tag, kernel, lib):
        """The kernel's and the library call's device time a call
        (profiler) and CUDA-event time with the L2 flushed."""
        k_dev, k_names = device_ms(torch, kernel, tag + "_kernel")
        l_dev, l_names = device_ms(torch, lib, tag + "_library")
        return dict(device_ms=k_dev, library_device_ms=l_dev,
                    cold_ms=cold_ms(torch, kernel),
                    library_cold_ms=cold_ms(torch, lib),
                    kernels=k_names, library_kernels=l_names)

    # -- store read: C in {4096, 65536} x 384, ties and signed zeros ------
    for C in (4096, 65536):
        mem = rng.normal(size=(C, 384)).astype(np.float32)
        mem /= np.linalg.norm(mem, axis=1, keepdims=True)
        mem[C // 2] = mem[C - 1] = mem[C // 3]          # exact ties
        mem[1], mem[2] = 0.0, -0.0                      # sims of +-0
        bits = (rng.random(C) < 0.7).astype(np.int32) * mt.MASK_VALID
        memp, maskp = mt.to_padded_layout(torch.from_numpy(mem),
                                          torch.from_numpy(bits))
        memp, maskp = memp.to(dev), maskp.to(dev)
        valid = (maskp[:, 0] & 1) == 1
        for B in (1, 8, 32):
            qs = rng.normal(size=(B, 384)).astype(np.float32)
            qs /= np.linalg.norm(qs, axis=1, keepdims=True)
            qs[0] = mem[C // 3]
            qs = torch.from_numpy(qs).to(dev)
            for k in (1, 4, 8):
                cs, ci = mt.memory_topk_batch_padded_cuda(memp, qs, maskp, k)
                ps, pi = mt.memory_topk_batch_padded_plain(memp, qs, maskp,
                                                           k)
                torch.cuda.synchronize()
                if not torch.equal(ci, pi):
                    raise AssertionError(f"top-k rows differ at C={C} "
                                         f"B={B} k={k}")
                err = (cs - ps).abs().max().item()
                if err > TOPK_TOL:
                    raise AssertionError(f"top-k sims off by {err}")

                def lib():
                    s = torch.where(valid[None], qs @ memp.T, -2.0)
                    return torch.topk(s, k, dim=1)
                def kernel():
                    return mt.memory_topk_batch_padded_cuda(memp, qs, maskp,
                                                            k)
                b = bound(memp.numel() * 4 + maskp.numel() * 4 +
                          qs.numel() * 4 + B * k * 8,
                          2 * C * 384 * B, F32_FLOPS)
                extra = (card_times(f"topk_C{C}_B{B}", kernel, lib)
                         if k == 1 else {})
                record("memory_topk", f"C={C} E=384 B={B} k={k}", err,
                       time_ms(torch, kernel),
                       time_ms(torch, lambda: mt.memory_topk_batch_padded_plain(
                           memp, qs, maskp, k)),
                       time_ms(torch, lib), b, **extra)

    # -- the IVF read's level 2: top-k over 4 probed clusters' rows -------
    # (core/memory_ivf.py: B=1, k=4, 4 x 64 rows of the 65536-row,
    # 1024-cluster store of Phase I2)
    C, k = 256, 4
    mem = rng.normal(size=(C, 384)).astype(np.float32)
    mem /= np.linalg.norm(mem, axis=1, keepdims=True)
    mem[C // 2] = mem[C // 3]
    bits = np.full(C, mt.MASK_VALID, np.int32)
    memp, maskp = mt.to_padded_layout(torch.from_numpy(mem),
                                      torch.from_numpy(bits))
    memp, maskp = memp.to(dev), maskp.to(dev)
    q = torch.from_numpy(mem[C // 3][None]).to(dev)
    cs, ci = mt.memory_topk_batch_padded_cuda(memp, q, maskp, k)
    ps, pi = mt.memory_topk_batch_padded_plain(memp, q, maskp, k)
    torch.cuda.synchronize()
    if not torch.equal(ci, pi):
        raise AssertionError("top-k rows differ on the IVF read")
    err = (cs - ps).abs().max().item()
    if err > TOPK_TOL:
        raise AssertionError(f"top-k sims off by {err} on the IVF read")

    def ivf_kernel():
        return mt.memory_topk_batch_padded_cuda(memp, q, maskp, k)

    def ivf_lib():
        return torch.topk(q @ memp.T, k, dim=1)
    record("memory_topk", f"C={C} E=384 B=1 k={k} (IVF read)", err,
           time_ms(torch, ivf_kernel),
           time_ms(torch, lambda: mt.memory_topk_batch_padded_plain(
               memp, q, maskp, k)),
           time_ms(torch, ivf_lib),
           bound(memp.numel() * 4 + maskp.numel() * 4 + q.numel() * 4 +
                 k * 8, 2 * C * 384, F32_FLOPS),
           **card_times("topk_ivf_read", ivf_kernel, ivf_lib))

    # -- top-1 store read: C in {4096, 65536} x 384, both views ----------
    for C in (4096, 65536):
        mem = rng.normal(size=(C, 384)).astype(np.float32)
        mem /= np.linalg.norm(mem, axis=1, keepdims=True)
        mem[C // 2] = mem[C - 1] = mem[C // 3]          # exact ties
        mem[1], mem[2] = 0.0, -0.0                      # sims of +-0
        bits = ((rng.random(C) < 0.7) * mt.MASK_VALID +
                (rng.random(C) < 0.5) * mt.MASK_GUIDE).astype(np.int32)
        memp, maskp = mt.to_padded_layout(torch.from_numpy(mem),
                                          torch.from_numpy(bits))
        memp, maskp = memp.to(dev), maskp.to(dev)
        for B in (1, 8, 32):
            qs = rng.normal(size=(B, 384)).astype(np.float32)
            qs /= np.linalg.norm(qs, axis=1, keepdims=True)
            qs[0] = mem[C // 3]
            qs = torch.from_numpy(qs).to(dev)
            for req in (mt.MASK_VALID, mt.MASK_VALID | mt.MASK_GUIDE):
                cs, ci = mt.memory_top1_batch_padded_cuda(memp, qs, maskp,
                                                          req)
                ps, pi = mt.memory_top1_batch_padded_plain(memp, qs, maskp,
                                                           req)
                torch.cuda.synchronize()
                if not torch.equal(ci, pi):
                    raise AssertionError(f"top-1 rows differ at C={C} "
                                         f"B={B} required={req}")
                err = (cs - ps).abs().max().item()
                if err > TOPK_TOL:
                    raise AssertionError(f"top-1 sims off by {err}")
                view = (maskp[:, 0] & req) == req

                def lib():
                    return torch.argmax(torch.where(view[None], qs @ memp.T,
                                                    -2.0), dim=1)
                def kernel():
                    return mt.memory_top1_batch_padded_cuda(memp, qs, maskp,
                                                            req)
                b = bound(memp.numel() * 4 + maskp.numel() * 4 +
                          qs.numel() * 4 + B * 8, 2 * C * 384 * B, F32_FLOPS)
                extra = (card_times(f"top1_C{C}_B{B}", kernel, lib)
                         if req == mt.MASK_VALID else {})
                record("memory_top1", f"C={C} E=384 B={B} required={req}",
                       err, time_ms(torch, kernel),
                       time_ms(torch, lambda: mt.memory_top1_batch_padded_plain(
                           memp, qs, maskp, req)),
                       time_ms(torch, lib), b, **extra)

    # -- the compact-layout top-1 wrappers: layout copy, then the kernel --
    C, B = 4096, 8
    mem = torch.from_numpy(rng.normal(size=(C, 384)).astype(np.float32))
    mem /= mem.norm(dim=1, keepdim=True)
    valid = torch.from_numpy(rng.random(C) < 0.7)
    qs = mem[:B].clone()
    mem, valid, qs = mem.to(dev), valid.to(dev), qs.to(dev)
    cs, ci = ops.memory_top1_batch(mem, qs, valid)
    ps, pi = mt.memory_top1_batch_plain(mem, qs, valid)
    torch.cuda.synchronize()
    if not torch.equal(ci, pi):
        raise AssertionError("compact top-1 rows differ")
    err = (cs - ps).abs().max().item()
    record("memory_top1_compact", f"C={C} E=384 B={B}", err,
           time_ms(torch, lambda: ops.memory_top1_batch(mem, qs, valid)),
           time_ms(torch, lambda: mt.memory_top1_batch_plain(mem, qs,
                                                             valid)),
           time_ms(torch, lambda: torch.argmax(torch.where(
               valid[None], qs @ mem.T, -2.0), dim=1)),
           bound(mem.numel() * 4 + C + qs.numel() * 4 + B * 8,
                 2 * C * 384 * B, F32_FLOPS))

    # -- IVF route: centroid planes of 64 and 1024 clusters ---------------
    for P in (64, 1024):
        cent = rng.normal(size=(P, 384)).astype(np.float32)
        cent /= np.linalg.norm(cent, axis=1, keepdims=True)
        cent[P // 2] = cent[0]                          # tied centroids
        seeded = (rng.random(P) < 0.9).astype(np.int32) * mt.MASK_VALID
        centp, cmaskp = mt.to_padded_layout(torch.from_numpy(cent),
                                            torch.from_numpy(seeded))
        centp, cmaskp = centp.to(dev), cmaskp.to(dev)
        live = cmaskp[:, 0] == mt.MASK_VALID
        for B in (1, 8, 32):
            qs = rng.normal(size=(B, 384)).astype(np.float32)
            qs /= np.linalg.norm(qs, axis=1, keepdims=True)
            qs[0] = cent[0]
            qs = torch.from_numpy(qs).to(dev)
            for n_probe in (4, 64):
                cs, ci = ivf.ivf_route_batch_padded_cuda(centp, qs, cmaskp,
                                                         n_probe)
                ps, pi = ivf.ivf_route_batch_padded_plain(centp, qs, cmaskp,
                                                          n_probe)
                torch.cuda.synchronize()
                if not torch.equal(ci, pi):
                    raise AssertionError(f"route rows differ at P={P} "
                                         f"B={B} n_probe={n_probe}")
                err = (cs - ps).abs().max().item()
                if err > TOPK_TOL:
                    raise AssertionError(f"route scores off by {err}")

                def lib():
                    s = torch.where(live[:, None], centp @ qs.T, -2.0)
                    return torch.topk(s.T, n_probe, dim=1)

                def kernel():
                    return ivf.ivf_route_batch_padded_cuda(centp, qs, cmaskp,
                                                           n_probe)
                b = bound(centp.numel() * 4 + cmaskp.numel() * 4 +
                          qs.numel() * 4 + B * n_probe * 8,
                          2 * P * 384 * B, F32_FLOPS)
                record("ivf_route", f"P={P} E=384 B={B} n_probe={n_probe}",
                       err, time_ms(torch, kernel),
                       time_ms(torch, lambda: ivf.ivf_route_batch_padded_plain(
                           centp, qs, cmaskp, n_probe)),
                       time_ms(torch, lib), b,
                       **card_times(f"route_P{P}_B{B}_n{n_probe}", kernel,
                                    lib))

    # -- IVF candidate read: Phase I2's indexed store, its routes ---------
    from repro_torch.core.memory_ivf import wrap_store
    cfg, full_store, i2_rng, protos, _ = i2_store(torch)
    store = wrap_store(full_store(dev), cfg)
    store._refresh()
    (cent, cmask, cidmap), st = store._planes[0], store.store
    members, assign, emb = store._members_dev, store._assign_dev, st.emb
    maskp, C, Ep = st.mask, store.capacity, emb.shape[1]
    n_probe, M = store.probes, store.bucket_cap
    for B in (1, 8, 32):
        qs = torch.from_numpy(near(i2_rng, protos, B)).to(dev)
        scores, cids = ops.ivf_route_batch_padded(cent, qs, cmask, n_probe)
        slots, ok = ivf.gather_candidates(members, assign, scores,
                                          ivf.global_cids(cids, cidmap))
        kept = int(ok.sum())
        for k in (1, 4):
            args = (scores, cids, cidmap, members, assign, emb, maskp,
                    st.hard, st.added_at, st.guide, qs, k, mt.MASK_VALID)
            cs, cm = ivf.ivf_scan_batch_cuda(*args)
            ps, pm = ivf.ivf_scan_batch_plain(*args)
            torch.cuda.synchronize()
            if not torch.equal(cm, pm):
                raise AssertionError(f"ivf_scan rows or meta differ at B={B} "
                                     f"k={k}")
            err = (cs - ps).abs().max().item()
            if err > TOPK_TOL:
                raise AssertionError(f"ivf_scan sims off by {err}")

            def kernel():
                return ivf.ivf_scan_batch_cuda(*args)

            def lib():
                """The eager path: gather the candidates' rows, one batched
                product, torch.topk, then the winners' meta."""
                s, o = ivf.gather_candidates(members, assign, scores,
                                             ivf.global_cids(cids, cidmap))
                rows = emb[s.long().clamp(0, C - 1)]
                sims = torch.bmm(rows, F.pad(qs, (0, Ep - qs.shape[1]))
                                 [:, :, None])[..., 0]
                top, at = torch.topk(torch.where(o, sims, -2.0), k, dim=1)
                idx = s.gather(1, at).clamp(0, C - 1)
                return top, mt.pack_meta_parts(idx, maskp[idx.long(), 0],
                                               st.hard, st.added_at, st.guide)
            G = st.guide.shape[1]
            b = bound(kept * Ep * 4 + B * n_probe * M * 12 + B * n_probe * 8 +
                      qs.numel() * 4 + B * k * (4 + 4 * (4 + G)),
                      2 * kept * Ep, F32_FLOPS)
            record("ivf_scan", f"C={C} P={store.clusters} n_probe={n_probe} "
                   f"M={M} B={B} k={k}", err, time_ms(torch, kernel),
                   time_ms(torch, lambda: ivf.ivf_scan_batch_plain(*args)),
                   time_ms(torch, lib), b, kept=kept,
                   **card_times(f"ivf_scan_B{B}_k{k}", kernel, lib))
    del store, st, emb, members, assign

    # -- attention at the tiers', the embedder's and llama3-8b's shapes ---
    def attn_case(tag, B, Sq, H, KV, hd, dtype, window=0, causal=True,
                  kv_len=None, Sk=None, timed=False):
        """``Sk`` keys (default Sq), the queries aligned to their end;
        ``timed`` (and llama3-8b) adds the device and L2-cold times."""
        Sk = Sq if Sk is None else Sk
        g = torch.Generator(device=dev).manual_seed(Sq * 1000 + Sk + H)
        q = torch.randn((B, Sq, H, hd), generator=g, device=dev).to(dtype)
        k = torch.randn((B, Sk, KV, hd), generator=g, device=dev).to(dtype)
        v = torch.randn((B, Sk, KV, hd), generator=g, device=dev).to(dtype)
        kl = None if kv_len is None else torch.full(
            (B,), kv_len, dtype=torch.int32, device=dev)
        kw = dict(causal=causal, window=window, kv_len=kl)
        got = fa.flash_attention_cuda(q, k, v, **kw)
        want = fa.flash_attention_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        tol = ATTN_TOL[str(dtype).split(".")[1]]
        if not err <= tol:
            raise AssertionError(f"flash {tag} Sq={Sq} Sk={Sk}: err {err} > "
                                 f"{tol}")
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        kpos = torch.arange(Sk, device=dev)
        d = (torch.arange(Sq, device=dev) + (Sk - Sq))[:, None] - kpos[None]
        mask = torch.ones((Sq, Sk), dtype=torch.bool, device=dev)
        if causal:
            mask &= d >= 0
        if window:
            mask &= d < window
        if kl is not None:
            mask &= kpos[None, :] < kv_len
        pairs = B * H * int(mask.sum())
        # SDPA's own causal mask is aligned to the start, ours to the end
        if not (window or kl is not None or (causal and Sq != Sk)):
            mask = None

        def lib():
            return F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask,
                is_causal=causal and mask is None, enable_gqa=True)
        es = q.element_size()
        b = bound((2 * q.numel() + 2 * k.numel()) * es, 4 * pairs * hd,
                  BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS)

        def kernel():
            return fa.flash_attention_cuda(q, k, v, **kw)
        key = (f"{tag} B={B} Sq={Sq} H={H} KV={KV} hd={hd} "
               f"{str(dtype)[6:]} window={window} causal={causal}"
               + ("" if Sk == Sq else f" Sk={Sk}")
               + ("" if kv_len is None else f" kv_len={kv_len}"))
        extra = (card_times(f"flash_{tag.split()[0]}_Sq{Sq}_Sk{Sk}_w{window}"
                            f"_hd{hd}", kernel, lib)
                 if tag == "llama3-8b" or timed else {})
        record("flash_attention", key, err, time_ms(torch, kernel),
               time_ms(torch, lambda: fa.flash_attention_plain(q, k, v,
                                                               **kw)),
               time_ms(torch, lib), b, **extra)

    def decode_case(tag, B, M, cl, H, KV, hd, dtype, window=0, ring=False,
                    timed=False):
        """``cl``: one cache length for every row, or a list of B. It goes
        in as a (B,) int32 tensor already on the card, as the model passes
        it, so no timed call pays a host-to-device copy. ``ring``: the
        cache is a ring of M slots (position p in slot p % M). ``timed``
        (and llama3-8b) adds the device and L2-cold times."""
        g = torch.Generator(device=dev).manual_seed(M * 1000 + H)
        q = torch.randn((B, H, hd), generator=g, device=dev).to(dtype)
        k = torch.randn((B, M, KV, hd), generator=g, device=dev).to(dtype)
        v = torch.randn((B, M, KV, hd), generator=g, device=dev).to(dtype)
        lens = [cl] * B if isinstance(cl, int) else list(cl)
        clt = torch.tensor(lens, dtype=torch.int32, device=dev)
        got = da.decode_attention_cuda(q, k, v, clt, window=window, ring=ring)
        want = da.decode_attention_plain(q, k, v, clt, window=window,
                                         ring=ring)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        tol = ATTN_TOL[str(dtype).split(".")[1]]
        if not err <= tol:
            raise AssertionError(f"decode {tag} M={M} cache_len={cl}: err "
                                 f"{err} > {tol}")
        spans = [(max(0, n - window) if window else 0, min(M, n))
                 for n in lens]
        if ring:            # the valid positions, their number
            spans = [(max(0, n - min(window or M, M)), n) for n in lens]
        qt = q[:, :, None]
        if ring:
            # every slot holding a valid position (all M once the ring
            # has wrapped, with no window)
            kt, vt = k.transpose(1, 2), v.transpose(1, 2)
            slot = torch.arange(M, device=dev)
            mask = torch.stack([
                (n - 1 - (n - 1 - slot) % M >= lo) for n, (lo, _)
                in zip(lens, spans)])[:, None, None, :]
        elif len(set(lens)) == 1:
            lo, hi = spans[0]
            kt = k[:, lo:hi].transpose(1, 2)
            vt = v[:, lo:hi].transpose(1, 2)
            mask = None
        else:
            kt, vt = k.transpose(1, 2), v.transpose(1, 2)
            pos = torch.arange(M, device=dev)
            mask = torch.stack([(pos >= lo) & (pos < hi)
                                for lo, hi in spans])[:, None, None, :]

        def lib():
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                  enable_gqa=True)

        def kernel():
            return da.decode_attention_cuda(q, k, v, clt, window=window,
                                            ring=ring)
        n = sum(hi - lo for lo, hi in spans)
        es = q.element_size()
        b = bound((2 * q.numel() + 2 * n * KV * hd) * es, 4 * H * n * hd,
                  BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS)
        shown = cl if isinstance(cl, int) else list(cl)
        extra = (card_times(f"decode_{tag.split()[0]}_M{M}_w{window}_B{B}"
                            f"_hd{hd}{'_ring' if ring else ''}", kernel, lib)
                 if tag == "llama3-8b" or timed else {})
        record("decode_attention",
               f"{tag} B={B} M={M} cache_len={shown} H={H} KV={KV} hd={hd} "
               f"{str(dtype)[6:]} window={window}"
               + (" ring" if ring else ""), err,
               time_ms(torch, kernel),
               time_ms(torch, lambda: da.decode_attention_plain(
                   q, k, v, clt, window=window, ring=ring)),
               time_ms(torch, lib), b, **extra)

    def decode_empty_cache(H, KV, hd, dtype):
        """cache_len 0 in one row gives zeros there (the kernel's rule,
        after decode_attention_pallas) and the plain answer in the other."""
        g = torch.Generator(device=dev).manual_seed(7)
        q = torch.randn((2, H, hd), generator=g, device=dev).to(dtype)
        k = torch.randn((2, 64, KV, hd), generator=g, device=dev).to(dtype)
        clt = torch.tensor([0, 50], dtype=torch.int32, device=dev)
        got = da.decode_attention_cuda(q, k, k, clt).float()
        want = da.decode_attention_plain(q, k, k, clt).float()
        torch.cuda.synchronize()
        if not torch.equal(got[0], torch.zeros_like(got[0])):
            raise AssertionError("decode with cache_len 0 is not zeros")
        err = (got[1] - want[1]).abs().max().item()
        if not err <= ATTN_TOL[str(dtype).split(".")[1]]:
            raise AssertionError(f"decode next to an empty row: err {err}")
        log(f"K decode_attention cache_len=[0, 50] H={H} KV={KV} hd={hd} "
            f"{str(dtype)[6:]}: row 0 zeros, row 1 max_abs_err={err:.3e}")

    f32, bf16 = torch.float32, torch.bfloat16
    for Sq in (1, 7, 17, 26, 130):
        attn_case("rar-weak", 8, Sq, 4, 4, 32, f32)
        attn_case("rar-strong", 8, Sq, 6, 6, 32, f32)
        decode_case("rar-weak", 8, Sq + 2, Sq + 1, 4, 4, 32, f32)
        decode_case("rar-strong", 8, Sq + 2, Sq + 1, 6, 6, 32, f32)
    attn_case("embedder", 32, 16, 4, 4, 32, f32, causal=False, kv_len=10)
    for Sq in (17, 130, 300):
        for window in (0, 64):
            attn_case("llama3-8b", 1, Sq, 32, 8, 128, bf16, window=window)
            decode_case("llama3-8b", 1, Sq + LLAMA_MAX_NEW, Sq + 1, 32, 8,
                        128, bf16, window=window)
        attn_case("llama3-8b", 1, Sq, 32, 8, 128, bf16, kv_len=Sq - 7)
    # split-KV: several chunks with keys, a window of 100 keys (7 chunks of
    # 16 from its start), cache_len per row, an empty row
    for cl in (1024, 4096):
        decode_case("llama3-8b", 1, cl + LLAMA_MAX_NEW, cl, 32, 8, 128, bf16)
    decode_case("llama3-8b", 1, 1024 + LLAMA_MAX_NEW, 1024, 32, 8, 128, bf16,
                window=100)
    decode_case("llama3-8b", 8, 300 + LLAMA_MAX_NEW,
                [301, 17, 130, 300, 1, 64, 255, 308], 32, 8, 128, bf16)
    decode_case("rar-strong", 8, 132, [131, 3, 64, 132, 1, 77, 100, 16], 6,
                6, 32, f32)
    # the ring KV cache: a 4096-slot ring past its wrap (all slots valid,
    # against the prefix read of cache 4096 above), a window inside the
    # ring, per-row lengths before and after the wrap
    decode_case("llama3-8b", 1, 4096, 2 * 4096 + 100, 32, 8, 128, bf16,
                ring=True)
    decode_case("llama3-8b", 1, 4096, 2 * 4096 + 100, 32, 8, 128, bf16,
                window=1024, ring=True)
    decode_case("olmoe-1b-7b", 2, 256, [300, 200], 16, 16, 128, bf16,
                ring=True)
    # the zoo at the shapes Phase Z gives the kernels: each Z1/Z2 model's
    # heads, head width and dtype, its prompts' prefills (after the vlm's
    # patches) and their first decode step's cache, at each window its
    # layers have; whisper's encoder over its frames and its cross reads
    # (the prefill's queries against every frame, non-causal, and a decode
    # step's over all of them); each Z3 ring at its slots and the window
    # its layers pass (a layer's own, else decode_window), with rows
    # before, at and past the wrap. The widest prompt of each new head
    # width, and whisper's encoder and cross reads, carry device times.
    from repro_torch import configs
    for arch, lengths, _ in Z_MODELS:
        cfg = configs.get(arch)
        if cfg.family == "ssm":                 # no attention
            continue
        shape = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                 getattr(torch, cfg.param_dtype))
        extra = cfg.num_patches if cfg.family == "vlm" else 0
        for n in lengths:
            Sq = n + extra
            timed = cfg.head_dim in (96, 256) and n == max(lengths)
            for window in sorted(set(cfg.layer_windows())):
                attn_case(arch, 1, Sq, *shape, window=window, timed=timed)
                decode_case(arch, 1, Sq + Z_MAX_NEW, Sq + 1, *shape,
                            window=window, timed=timed)
            if cfg.family == "audio":
                attn_case(f"{arch} cross", 1, n, *shape, causal=False,
                          Sk=cfg.encoder_frames, timed=n == max(lengths))
        if cfg.family == "audio":
            F_ = cfg.encoder_frames
            attn_case(f"{arch} encoder", 1, F_, *shape, causal=False,
                      timed=True)
            decode_case(f"{arch} cross", 1, F_, F_, *shape, timed=True)
    # f32 at the new widths (the kernels' f32 path; the zoo serves bf16)
    attn_case("f32 hd96", 1, 273, 32, 32, 96, f32)
    attn_case("f32 hd256", 1, 130, 10, 1, 256, f32, window=64)
    decode_case("f32 hd96", 1, 282, 274, 32, 32, 96, f32)
    decode_case("f32 hd256", 1, 139, 131, 10, 1, 256, f32)
    for arch, M, steps, B, _ in Z_RINGS:
        cfg = configs.get(arch)
        shape = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                 getattr(torch, cfg.param_dtype))
        for window in sorted({w if w > 0 else M
                              for w in cfg.layer_windows()}):
            for lens in ([steps, M + 1], [M, M // 2]):
                decode_case(arch, B, M, lens, *shape, window=window,
                            ring=True)
    decode_empty_cache(32, 8, 128, bf16)
    decode_empty_cache(6, 6, 32, f32)
    return rows


# ---------------------------------------------------------------------------
# Phase R: the RAR microbatch path, card against CPU
# ---------------------------------------------------------------------------


def workload():
    import numpy as np

    from repro_torch.data.tokenizer import Vocab
    vocab = Vocab(n_domains=3)
    prompts, greqs, embs = [], [], []
    i = 0
    while len(prompts) < POOL:
        d, s, x = i % 3, (i // 3) % 16, (i // 48) % 10
        i += 1
        prompts.append(np.asarray(vocab.question(d, s, x), np.int32))
        greqs.append(np.asarray(vocab.guide_request(d, s), np.int32))
        rng = np.random.default_rng(abs(hash((d, s, x))) % (2 ** 31))
        e = rng.normal(size=384).astype(np.float32)
        embs.append(e / np.linalg.norm(e))
    return vocab, prompts, greqs, np.stack(embs)


def to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: to_device(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def serve_rar(device, tiers, emb_params, mb, prompts, greqs, embs, vocab,
              cfg=None, memory=None, flush_each=False, setup=None,
              fault_plan=None, start=0):
    """Serve the workload through ``MicrobatchRAR`` on ``device`` (PASSES
    passes at microbatch ``mb``, from request ``start`` of the stream).
    ``flush_each`` puts a shadow barrier after every batch; every run ends
    on one; ``setup(ctrl)`` runs before serving. Returns the controller,
    the Outcomes, the wall time, the embeddings computed (R2) and every
    top-1 sim the serve plane read."""
    import numpy as np

    from repro_torch.configs import rar_system
    from repro_torch.core import embedder
    from repro_torch.core.fm import FMTier
    from repro_torch.core.pipeline import MicrobatchRAR

    weak = FMTier.create("weak", rar_system.WEAK,
                         to_device(tiers[0], device), vocab)
    strong = FMTier.create("strong", rar_system.STRONG,
                           to_device(tiers[1], device), vocab)
    seen = []

    def embed_batch(ps):
        toks = np.zeros((len(ps), SEQ_LEN), np.int32)
        for i, p in enumerate(ps):
            toks[i, :len(p)] = p
        out = embedder.embed(rar_system.EMBEDDER, emb_params, toks)
        seen.append(out.cpu())
        return out

    ctrl = MicrobatchRAR(weak, strong, None, lambda e, k: False,
                         cfg or rar_system.make_rar_config(), device=device,
                         memory=memory, fault_plan=fault_plan,
                         embed_batch_fn=(None if emb_params is None
                                         else embed_batch))
    if setup is not None:
        setup(ctrl)
    sims = []
    lookup = ctrl._lookup_batch

    def recorded_lookup(embs, guides_only=False):
        q = lookup(embs, guides_only=guides_only)
        if not guides_only:
            sims.append(np.asarray(q.sim)[:, 0])
        return q
    ctrl._lookup_batch = recorded_lookup
    outs = []
    t0 = time.perf_counter()
    for pos in range(start, PASSES * POOL, mb):
        first = pos % POOL
        sl = slice(first, first + mb)
        outs += ctrl.process_batch(
            prompts[sl], greqs[sl],
            keys=list(range(first, first + len(prompts[sl]))),
            embs=None if emb_params is not None else embs[sl])
        if flush_each:
            ctrl.flush_shadow(timeout=WAIT_S)
    ctrl.flush_shadow(timeout=WAIT_S)
    if device.type == "cuda":
        import torch
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return ctrl, outs, dt, seen, np.concatenate(sims)


def same_store(a, b, emb_atol=0.0):
    """Every store field equal; ``emb`` within ``emb_atol`` (R2 stores
    embeddings computed on either device). A sharded store is compared as
    the single-device store it gathers into."""
    import torch
    a, b = (getattr(x, "to_single_device", lambda x=x: x)() for x in (a, b))
    err = (a.emb.cpu() - b.emb.cpu()).abs().max().item()
    if err > emb_atol:
        raise AssertionError(f"store emb differs card vs CPU by {err}")
    for f in ("guide", "has_guide", "hard", "valid", "added_at"):
        if not torch.equal(getattr(a, f).cpu(), getattr(b, f).cpu()):
            raise AssertionError(f"store field {f} differs card vs CPU")
    if a.ptr != b.ptr:
        raise AssertionError("store ptr differs card vs CPU")


def min_logit_gap(torch, tiers, prompts, greqs, dev):
    import numpy as np

    from repro_torch.configs import rar_system
    from repro_torch.models import prefill
    gaps = []
    for cfg, params, batch in ((rar_system.WEAK, tiers[0], prompts),
                               (rar_system.STRONG, tiers[1], prompts),
                               (rar_system.STRONG, tiers[1], greqs)):
        p = to_device(params, dev)
        by_len = {}
        for x in batch:
            by_len.setdefault(len(x), []).append(x)
        for xs in by_len.values():
            t = torch.from_numpy(np.stack(xs)).long().to(dev)
            logits = prefill(cfg, p, {"tokens": t}, t.shape[1] + 1)[0]
            top = torch.topk(logits, 2, dim=-1).values
            gaps.append((top[:, 0] - top[:, 1]).min().item())
    return min(gaps)


def phase_r(torch, ops):
    import numpy as np

    from repro_torch.configs import rar_system
    from repro_torch.core import embedder
    from repro_torch.models import init_params

    cuda, cpu = torch.device(DEV), torch.device("cpu")
    vocab, prompts, greqs, embs = workload()
    tiers = (init_params(rar_system.WEAK, SEEDS["weak"], device=cuda),
             init_params(rar_system.STRONG, SEEDS["strong"], device=cuda))
    log(f"R seeds: weak={SEEDS['weak']} strong={SEEDS['strong']} "
        f"embedder={SEEDS['embedder']} (torch.Generator); store 4096 x 384")
    log(f"R min top-2 logit gap over the served prompts' first tokens: "
        f"{min_logit_gap(torch, tiers, prompts, greqs, cuda):.6f}")
    counts = {}
    emb_cuda = embedder.init_params(rar_system.EMBEDDER, SEEDS["embedder"],
                                    device=cuda)
    results = {}
    for phase, emb_params in (("R1", None), ("R2", emb_cuda)):
        for mb in MICROBATCHES:
            ops.reset_launches()
            c_ctrl, c_outs, c_dt, c_seen, _ = serve_rar(
                cuda, tiers, emb_params, mb, prompts, greqs, embs, vocab)
            got = ops.launch_counts()
            for k, v in got.items():
                counts[k] = counts.get(k, 0) + v
            log(f"{phase} mb={mb} launches on the card: {got}")
            h_ctrl, h_outs, h_dt, h_seen, _ = serve_rar(
                cpu, tiers, None if emb_params is None else
                to_device(emb_params, cpu), mb, prompts, greqs, embs, vocab)
            if [dataclasses.astuple(o) for o in c_outs] != \
                    [dataclasses.astuple(o) for o in h_outs]:
                raise AssertionError(f"{phase} mb={mb}: Outcome streams "
                                     f"differ card vs CPU")
            for tier in ("weak", "strong"):
                a = getattr(c_ctrl, tier).engine.stats()
                b = getattr(h_ctrl, tier).engine.stats()
                if a != b:
                    raise AssertionError(f"{phase} {tier} engine stats "
                                         f"differ: {a} vs {b}")
            same_store(c_ctrl.memory, h_ctrl.memory,
                       0.0 if emb_params is None else 1e-5)
            strong = sum(o.strong_calls for o in c_outs)
            n = PASSES * POOL
            # the JAX record is for the hash embeddings (R1) only
            record = (f" (JAX record {JAX_STRONG_CALLS})"
                      if emb_params is None else "")
            line = (f"{phase} mb={mb}: strong calls {strong} per {n} "
                    f"requests{record}; weak calls "
                    f"{c_ctrl.weak.calls}; card {n / c_dt:.1f} req/s "
                    f"({c_dt * 1e3 / n:.3f} ms/req); CPU {n / h_dt:.1f} "
                    f"req/s")
            if emb_params is not None:
                a = torch.cat(c_seen)
                b = torch.cat(h_seen)
                cos = (a * b).sum(-1) / a.norm(dim=-1) / b.norm(dim=-1)
                if cos.min().item() < 1 - 1e-5:
                    raise AssertionError(f"R2 embedding cosine "
                                         f"{cos.min().item()}")
                e = a[:POOL].numpy()
                sims = e @ e.T
                np.fill_diagonal(sims, 0.0)
                margin = np.abs(sims - 0.6).min()
                line += (f"; embedding cosine card/CPU min "
                         f"{cos.min().item():.8f}; closest pairwise sim to "
                         f"the 0.6 threshold is {margin:.4f} away")
            log(line)
            results[f"{phase}_mb{mb}"] = dict(
                strong_calls=strong, req_per_s=n / c_dt,
                outcomes=[dataclasses.astuple(o) for o in c_outs],
                ctrl=c_ctrl)
    for k in ("memory_topk", "flash_attention", "decode_attention"):
        if counts.get(k, 0) == 0:
            raise AssertionError(f"Phase R never launched {k}")
    return counts, results, tiers


# ---------------------------------------------------------------------------
# Phase I: the IVF retrieval plane, card against CPU
# ---------------------------------------------------------------------------


def check_same_serving(tag, c, h):
    """Card and CPU runs of one serving step: identical Outcome streams,
    engine stats, stores and IVF stats. ``c``/``h`` are serve_rar's
    returns."""
    if [dataclasses.astuple(o) for o in c[1]] != \
            [dataclasses.astuple(o) for o in h[1]]:
        raise AssertionError(f"{tag}: Outcome streams differ card vs CPU")
    for tier in ("weak", "strong"):
        a = getattr(c[0], tier).engine.stats()
        b = getattr(h[0], tier).engine.stats()
        if a != b:
            raise AssertionError(f"{tag} {tier} engine stats differ: {a} vs "
                                 f"{b}")
    same_store(c[0].memory.store, h[0].memory.store)
    if c[0].memory.stats() != h[0].memory.stats():
        raise AssertionError(f"{tag}: IVF stats differ card vs CPU: "
                             f"{c[0].memory.stats()} vs "
                             f"{h[0].memory.stats()}")


def log_launches(ops, seen, tag, steps):
    """Log the launches since the counts in ``seen`` (updated here), in
    all and per ``process_batch`` step."""
    now = ops.launch_counts()
    new = {k: v - seen.get(k, 0) for k, v in now.items() if v > seen.get(k, 0)}
    seen.update(now)
    log(f"{tag} launches on the card: {new}; per step "
        f"{ {k: v / steps for k, v in new.items()} }")


def threshold_margin(sims) -> float:
    """Smallest distance of a served sim (not a -2.0 sentinel) to the 0.6
    routing threshold."""
    import numpy as np
    live = sims[sims > -2.0]
    return float(np.abs(live - 0.6).min()) if live.size else float("inf")


def near(rng, protos, n):
    """``benchmarks/memory_bench.py``'s skill rows: a prototype plus 0.05
    noise per lane, renormalized."""
    import numpy as np
    rows = protos[rng.integers(0, len(protos), n)] + \
        0.05 * rng.normal(size=(n, protos.shape[1])).astype(np.float32)
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    return rows.astype(np.float32)


def i2_store(torch):
    """Phase I2's setting: the RAR config with the IVF plane on a
    65536 x 384 store, a function that builds that store full of clustered
    rows on a device, the rng (after the store's draws) and prototypes for
    the queries, and the rows."""
    import numpy as np

    from repro_torch.configs import rar_system
    from repro_torch.core import memory as mem
    from repro_torch.kernels.memory_topk import MASK_GUIDE, MASK_VALID

    C, clusters, probes = IVF_STORE
    rng = np.random.default_rng(SEEDS["store"])
    protos = rng.normal(size=(clusters, 384)).astype(np.float32)
    protos /= np.linalg.norm(protos, axis=1, keepdims=True)
    rows = near(rng, protos, C)
    # half the rows carry a guide (an empty block), so the guides-only
    # view of I3 is not empty; no workload query comes near these rows
    bits = MASK_VALID + MASK_GUIDE * (rng.random(C) < 0.5)
    base = rar_system.make_rar_config()
    mcfg = mem.MemoryConfig(capacity=C, embed_dim=384,
                            guide_len=base.memory.guide_len)
    cfg = dataclasses.replace(base, memory=mcfg, retrieval_clusters=clusters,
                              retrieval_probes=probes)

    def full_store(device):
        st = mem.init_memory(mcfg, device=device)
        st.emb[:C, :384] = torch.from_numpy(rows).to(device)
        st.mask[:C, 0] = torch.from_numpy(bits.astype(np.int32)).to(device)
        st.ptr = C
        return st

    log(f"I2 store: {C} x 384 clustered unit rows ({clusters} prototypes, "
        f"noise 0.05, seed {SEEDS['store']}, {int((bits > 1).sum())} with "
        f"a guide); IVF {clusters} clusters, {probes} probes")
    return cfg, full_store, rng, protos, rows


def phase_i(torch, ops, tiers, r_results):
    import numpy as np

    from repro_torch.configs import rar_system
    from repro_torch.core import memory as mem
    from repro_torch.kernels.memory_topk import MASK_VALID

    cuda, cpu = torch.device(DEV), torch.device("cpu")
    vocab, prompts, greqs, embs = workload()
    n = PASSES * POOL
    results = {}
    ops.reset_launches()
    seen = {}

    # I1: all clusters probed reproduce the exact scan, so R1's stream
    clusters, probes = IVF_EXACT
    cfg = rar_system.make_rar_config(retrieval_clusters=clusters,
                                     retrieval_probes=probes)
    for mb in MICROBATCHES:
        c = serve_rar(cuda, tiers, None, mb, prompts, greqs, embs, vocab,
                      cfg=cfg)
        h = serve_rar(cpu, tiers, None, mb, prompts, greqs, embs, vocab,
                      cfg=cfg)
        check_same_serving(f"I1 mb={mb}", c, h)
        log_launches(ops, seen, f"I1 mb={mb}", n // mb)
        if [dataclasses.astuple(o) for o in c[1]] != \
                r_results[f"R1_mb{mb}"]["outcomes"]:
            raise AssertionError(f"I1 mb={mb}: Outcome stream differs from "
                                 f"R1's exact scan")
        strong = sum(o.strong_calls for o in c[1])
        if strong != JAX_STRONG_CALLS:
            raise AssertionError(f"I1 mb={mb}: {strong} strong calls")
        log(f"I1 mb={mb}: IVF {clusters} clusters / {probes} probes on the "
            f"4096 store: Outcome streams == R1 and card == CPU; strong "
            f"calls {strong} per {n} requests (JAX record "
            f"{JAX_STRONG_CALLS}); IVF stats {c[0].memory.stats()}; "
            f"closest served sim to the 0.6 threshold "
            f"{threshold_margin(c[4]):.6f} away; card {n / c[2]:.1f} req/s,"
            f" CPU {n / h[2]:.1f} req/s")
        results[f"I1_mb{mb}"] = dict(strong_calls=strong,
                                     req_per_s=n / c[2])

    # I2: the size the plane exists for, a full store of clustered rows
    C, clusters, probes = IVF_STORE
    cfg, full_store, rng, protos, rows = i2_store(torch)
    served = {}
    for mb in MICROBATCHES:
        c = serve_rar(cuda, tiers, None, mb, prompts, greqs, embs, vocab,
                      cfg=cfg, memory=full_store(cuda))
        h = serve_rar(cpu, tiers, None, mb, prompts, greqs, embs, vocab,
                      cfg=cfg, memory=full_store(cpu))
        check_same_serving(f"I2 mb={mb}", c, h)
        log_launches(ops, seen, f"I2 mb={mb}", n // mb)
        strong = sum(o.strong_calls for o in c[1])
        log(f"I2 mb={mb}: card == CPU; strong calls {strong} per {n} "
            f"requests; bucket {c[0].memory.bucket_cap}, "
            f"{probes * c[0].memory.bucket_cap} candidates a query; IVF "
            f"stats {c[0].memory.stats()}; closest served sim to the 0.6 "
            f"threshold {threshold_margin(c[4]):.6f} away; card "
            f"{n / c[2]:.1f} req/s, CPU {n / h[2]:.1f} req/s")
        results[f"I2_mb{mb}"] = dict(
            strong_calls=strong, req_per_s=n / c[2], ctrl=c[0],
            outcomes=[dataclasses.astuple(o) for o in c[1]])
        served = dict(card=c[0].memory, cpu=h[0].memory)

    # I3: the top-1 reads on that store, card against CPU
    qs = near(rng, protos, 32)
    qs[0] = rows[C - 1]           # a filled row the workload left in place
    qs[1] = embs[0]               # an entry the workload wrote
    for guides_only in (False, True):
        a = mem.query_batch(served["card"].store, qs,
                            guides_only=guides_only).device_get()
        b = mem.query_batch(served["cpu"].store, qs,
                            guides_only=guides_only).device_get()
        pairs = [(a, b)] + [
            (mem.query(served["card"].store, q,
                       guides_only=guides_only).device_get(),
             mem.query(served["cpu"].store, q,
                       guides_only=guides_only).device_get())
            for q in qs[:4]]
        for x, y in pairs:
            if not np.array_equal(x.meta, y.meta):
                raise AssertionError(f"I3 guides_only={guides_only}: rows "
                                     f"or meta differ card vs CPU")
            err = float(np.abs(x.sim - y.sim).max())
            if err > TOPK_TOL:
                raise AssertionError(f"I3 sims off by {err}")
        log(f"I3 guides_only={guides_only}: query_batch (B=32) and 4 "
            f"single queries on the {C}-row store: rows and meta card == "
            f"CPU; best sims {np.round(a.sim[:4], 6).tolist()}")
    log_launches(ops, seen, "I3", 1)
    counts = ops.launch_counts()
    log(f"I launches on the card: {counts}")
    for k in ("ivf_route", "ivf_scan", "memory_top1"):
        if counts[k] == 0:
            raise AssertionError(f"Phase I never launched {k}")

    # recall and times of the IVF read against the exact scan (after the
    # counts: these are measurements, not the main path)
    ivf = served["card"]
    qr = near(rng, protos, 256)
    got = ivf.query_topk_batch(qr, 4).device_get().index
    want = ivf.exact_query_topk_batch(qr, 4).device_get().index
    recall = float(np.mean([len(set(got[i]) & set(want[i])) / 4
                            for i in range(len(qr))]))
    q32 = torch.from_numpy(qr[:32]).to(cuda)
    cent, cmask, cidmap = ivf._planes[0]
    scores, cids = ops.ivf_route_batch_padded(cent, q32, cmask, ivf.probes)

    def read():
        return ivf.query_topk_batch(q32, 4)

    def exact():
        return ivf.exact_query_topk_batch(q32, 4)
    ivf_ms, exact_ms = time_ms(torch, read), time_ms(torch, exact)
    dev_ms = {
        "route": device_ms(torch, lambda: ops.ivf_route_batch_padded(
            cent, q32, cmask, ivf.probes), "i2_route")[0],
        "scan": device_ms(torch, lambda: ops.ivf_scan_batch(
            scores, cids, cidmap, ivf._members_dev, ivf._assign_dev,
            ivf.store.emb, ivf.store.mask, ivf.store.hard,
            ivf.store.added_at, ivf.store.guide, q32, 4, MASK_VALID),
            "i2_scan")[0],
        "read": device_ms(torch, read, "i2_read")[0],
        "exact": device_ms(torch, exact, "i2_exact")[0]}
    shown = {k: "not measured" if v is None else f"{v:.4f} ms"
             for k, v in dev_ms.items()}
    log(f"I2 recall@4 of the IVF read against the exact scan over "
        f"{len(qr)} queries on the card: {recall:.4f}; query_topk_batch "
        f"B=32 k=4 (CUDA events): IVF {ivf_ms:.4f} ms, exact {exact_ms:.4f}"
        f" ms ({exact_ms / ivf_ms:.2f}x); device time a read: route "
        f"{shown['route']} + scan {shown['scan']}, whole IVF read "
        f"{shown['read']}, exact {shown['exact']}")
    if ivf_ms >= exact_ms or None not in (dev_ms["read"], dev_ms["exact"]) \
            and dev_ms["read"] >= dev_ms["exact"]:
        log("I2: the IVF read is NOT faster than the exact scan")
    results["I2_ivf"] = dict(recall_at_4=recall, ivf_ms=ivf_ms,
                             exact_ms=exact_ms, device_ms=dev_ms)
    results["I2_served"] = served
    return counts, results


# ---------------------------------------------------------------------------
# Phase L: llama3-8b at full width
# ---------------------------------------------------------------------------


def phase_l(torch, ops):
    import numpy as np

    from repro_torch.configs import llama3_8b
    from repro_torch.models import init_params
    from repro_torch.serving.engine import ServingEngine

    cfg = getattr(llama3_8b, LLAMA_CONFIG)
    cuda = torch.device(DEV)
    t0 = time.perf_counter()
    params = init_params(cfg, SEEDS["llama"], device=cuda)
    torch.cuda.synchronize()
    log(f"L {cfg.name}: {cfg.num_layers} layers (no cut), d_model "
        f"{cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads, vocab "
        f"{cfg.vocab_size}, {cfg.param_dtype}; random weights seed "
        f"{SEEDS['llama']} in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
               for n in LLAMA_LENGTHS]
    engine = ServingEngine(cfg, params)
    engine.generate_bucketed(prompts[:1], 2)        # warm the allocator
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    out = engine.generate_bucketed(prompts, LLAMA_MAX_NEW)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = ops.launch_counts()
    if out.shape != (len(prompts), LLAMA_MAX_NEW) or out.min() < 0 or \
            out.max() >= cfg.vocab_size:
        raise AssertionError(f"L: bad tokens {out.shape} "
                             f"[{out.min()}, {out.max()}]")
    for k in ("flash_attention", "decode_attention"):
        if counts[k] == 0:
            raise AssertionError(f"Phase L never launched {k}")
    toks = sum(LLAMA_LENGTHS) + len(prompts) * LLAMA_MAX_NEW
    log(f"L served {len(prompts)} requests (lengths {LLAMA_LENGTHS}, "
        f"max_new {LLAMA_MAX_NEW}) in {dt:.3f} s: "
        f"{dt * 1e3 / len(prompts):.1f} ms/request, {toks / dt:.1f} "
        f"tokens/s (prompt + generated), launches {counts}")
    return counts, dict(ms_per_request=dt * 1e3 / len(prompts),
                        tokens_per_s=toks / dt)


# ---------------------------------------------------------------------------
# Phase Z: the model zoo at full width
# ---------------------------------------------------------------------------


def busy_ms(torch, fn, tag):
    """The card's busy time (the union of its kernels', copies' and
    memsets' intervals) over one run of ``fn`` under ``torch.profiler``,
    and the profiled wall; (None, wall) if the profile caught no device
    activity."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = device_events(prof, ROOT / "build" / "trace" / f"{tag}.json")
    return (union_us(events) / 1e3 if events else None), wall


def union_us(events):
    """Microseconds in which some kernel, copy or memset of ``events``
    (chrome-trace device events) ran."""
    busy, end = 0.0, float("-inf")
    for s, t in sorted((e["ts"], e["ts"] + e["dur"]) for e in events):
        if t > end:
            busy += t - max(s, end)
            end = t
    return busy


def z_logit_check(torch, tag, got, want):
    """``got`` (the kernel path) against ``want`` (the training path,
    ``forward`` through ``layers.attention``), both (B, V) on the card:
    the max difference within Z_TOL of the reference's largest logit, and
    the same argmax in every row whose top-2 margin exceeds that bound.
    Returns the numbers logged."""
    got, want = got.float(), want.float()
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    rel_rms = ((got - want).norm() / want.norm()).item()
    tol = Z_TOL * scale
    top2 = want.topk(2, dim=-1).values
    margin = top2[:, 0] - top2[:, 1]
    same = got.argmax(-1) == want.argmax(-1)
    if not err <= tol or not bool((same | (margin <= tol)).all()):
        raise AssertionError(
            f"{tag}: max |diff| {err:.4g} against {tol:.4g} (Z_TOL x max "
            f"|logit| {scale:.4g}), rel rms {rel_rms:.3g}; argmax same "
            f"{same.tolist()} at margins {margin.tolist()}")
    return dict(err=err, scale=scale, rel_rms=rel_rms,
                argmax_same=int(same.sum()), rows=len(same))


def z_front(cfg, rng):
    """The family's frontend input for one request, seeded (standard
    normal f32 at d_model, as ``tests/test_models.py`` makes it): the vlm's
    patch embeddings or the audio family's frames; {} for the others."""
    import numpy as np
    n = {"vlm": cfg.num_patches, "audio": cfg.encoder_frames}.get(cfg.family)
    if n is None:
        return {}
    key = "patch_embeds" if cfg.family == "vlm" else "frames"
    return {key: rng.normal(size=(1, n, cfg.d_model)).astype(np.float32)}


def z_model(torch, ops, arch, lengths, cut=None, params=None):
    """Z1/Z2 for one arch at full width (depth cut to ``cut`` layers if
    given): random weights from a seed; the engine on seeded prompts of
    ``lengths`` with Z_MAX_NEW new tokens (``generate_bucketed``, or for a
    family with a frontend input ``generate`` on each prompt with its
    seeded patches or frames), timed, its kernel launches counted and its
    card busy share profiled; then, for each prompt, the prefill's last
    logits against ``forward`` on the prompt, and one decode step's
    against ``forward`` on the grown sequence. A moe model routes with its
    own capacity factor in the prefill check; its decode check runs at a
    capacity no token overflows (E / k), since a forward over S + 1 tokens
    has another capacity than the prefill over S and a decode step over 1,
    and drops other tokens. Flash and decode must launch in the serving
    run and in the checks, except for the ssm family, whose path must
    launch neither. Returns the launches of the serving run and the
    numbers. ``params`` (Phase T1's trained weights) replaces the random
    ones."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.models import decode_step, forward, init_params, prefill
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.tree import leaves

    cuda = torch.device(DEV)
    cfg = configs.get(arch)
    if cut is not None:
        cfg = dataclasses.replace(cfg, num_layers=cut)
    attention = cfg.family != "ssm"
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    made = params is None
    if made:
        params = init_params(cfg, Z_SEED, device=cuda)
    torch.cuda.synchronize()
    weights = sum(t.numel() * t.element_size()
                  for t in leaves(params)) / 1e9
    shape = {
        "ssm": f", d_inner {cfg.d_inner}, {cfg.ssm_heads} SSD heads of "
               f"{cfg.ssm_head_dim}, state {cfg.ssm_state}, chunk "
               f"{cfg.ssm_chunk}",
        "hybrid": f", blocks {''.join(cfg.block_pattern)}, d_rnn "
                  f"{cfg.d_rnn}",
        "vlm": f", {cfg.num_patches} patch embeddings",
        "audio": f", {cfg.encoder_layers} encoder layers over "
                 f"{cfg.encoder_frames} frames",
        "moe": f", {cfg.num_experts} experts top-{cfg.experts_per_token}",
    }.get(cfg.family, "")
    log(f"Z {cfg.name}: {cfg.family}, {cfg.num_layers} layers"
        f"{'' if cut is None else f' (depth cut from {configs.get(arch).num_layers})'}"
        f", d_model {cfg.d_model}"
        + (f", {cfg.num_heads}/{cfg.num_kv_heads} heads of {cfg.head_dim}"
           f", windows {sorted(set(cfg.layer_windows()))}" if attention
           else "")
        + f"{shape}, vocab {cfg.vocab_size}, "
        f"{'tied' if cfg.tie_embeddings else 'untied'}, {cfg.norm_type}, "
        f"{cfg.param_dtype}: {weights:.2f} GB of "
        + (f"random weights (seed {Z_SEED}) in "
           f"{time.perf_counter() - t0:.1f} s" if made else
           "trained weights"))
    rng = np.random.default_rng(Z_SEED)
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
               for n in lengths]
    fronts = [z_front(cfg, rng) for _ in lengths]
    engine = ServingEngine(cfg, params)

    def serve(k, max_new):
        if not fronts[0]:
            return engine.generate_bucketed(prompts[:k], max_new)
        return np.concatenate([
            engine.generate({"tokens": p[None], **f}, max_new).cpu().numpy()
            for p, f in zip(prompts[:k], fronts[:k])])
    serve(1, 2)                                     # warm the allocator
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    out = serve(len(prompts), Z_MAX_NEW)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = ops.launch_counts()
    if out.shape != (len(prompts), Z_MAX_NEW) or out.min() < 0 or \
            out.max() >= cfg.vocab_size:
        raise AssertionError(f"Z {arch}: bad tokens {out.shape}")
    for k in ("flash_attention", "decode_attention"):
        if attention and counts[k] == 0:
            raise AssertionError(f"Z {arch} never launched {k}")
        if not attention and counts[k]:
            raise AssertionError(f"Z {arch}: an attention-free model "
                                 f"launched {k} {counts[k]} times")
    busy, wall = busy_ms(torch, lambda: serve(len(prompts), Z_MAX_NEW),
                         f"z_{arch}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    toks = sum(lengths) + len(prompts) * Z_MAX_NEW
    res = dict(ms_per_request=dt * 1e3 / len(prompts), tokens_per_s=toks / dt,
               max_memory_gb=peak, weights_gb=weights,
               busy_share=None if busy is None else busy / wall, checks=[])
    log(f"Z {cfg.name} served {len(prompts)} requests (lengths "
        f"{tuple(lengths)}{' after the patches' if cfg.family == 'vlm' else ''}"
        f", max_new {Z_MAX_NEW}) in {dt:.3f} s: "
        f"{res['ms_per_request']:.1f} ms/request, {res['tokens_per_s']:.1f} "
        f"tokens/s (prompt + generated); max_memory_allocated {peak:.2f} GB; "
        f"card busy {'not measured' if busy is None else f'{busy:.1f} ms of a profiled {wall:.1f} ms ({100 * busy / wall:.1f}%)'}; "
        f"launches {counts}")

    def check(ccfg, prompt, front, what):
        t = torch.from_numpy(prompt).long().to(cuda)[None]
        fr = {k: torch.from_numpy(v).to(cuda) for k, v in front.items()}
        extra = cfg.num_patches if cfg.family == "vlm" else 0
        last, cache, pos = prefill(ccfg, params, {"tokens": t, **fr},
                                   len(prompt) + extra + 1)
        if what == "prefill":
            ref = forward(ccfg, params, {"tokens": t, **fr})[0][:, -1]
            return z_logit_check(torch, f"Z {arch} prefill S={len(prompt)}",
                                 last, ref)
        nxt = last.argmax(-1).to(torch.int32)
        step, _ = decode_step(ccfg, params, nxt, cache, pos)
        ref = forward(ccfg, params, {"tokens": torch.cat(
            [t, nxt[:, None].long()], 1), **fr})[0][:, -1]
        return z_logit_check(torch, f"Z {arch} decode pos={pos}", step, ref)

    nodrop = cfg if cfg.family != "moe" else dataclasses.replace(
        cfg, moe_capacity_factor=cfg.num_experts / cfg.experts_per_token)
    before = ops.launch_counts()
    for prompt, front in zip(prompts, fronts):
        for what, ccfg in (("prefill", cfg), ("decode", nodrop)):
            c = check(ccfg, prompt, front, what)
            res["checks"].append(dict(what=what, S=len(prompt), **c))
            log(f"Z {cfg.name} {what} check S={len(prompt)}"
                f"{' (capacity E/k)' if ccfg is not cfg else ''}: max |diff| "
                f"{c['err']:.4g} <= {Z_TOL} x max |logit| {c['scale']:.4g}; "
                f"rel rms {c['rel_rms']:.3g}; argmax same in "
                f"{c['argmax_same']}/{c['rows']}")
    after = ops.launch_counts()
    ran = [after[k] != before[k]
           for k in ("flash_attention", "decode_attention")]
    if ran != [attention] * 2:
        raise AssertionError(f"Z {arch}: the checks' kernel path launched "
                             f"flash/decode {ran}, expected {attention}")
    del params, engine
    torch.cuda.empty_cache()
    return counts, res


def z_ring(torch, ops, arch, window, steps, B, cut=None):
    """Z3: ``steps`` decode steps from position 0 of ``B`` seeded token
    streams with a ring of ``window`` slots (``ring_cache``) and with the
    full cache at the same ``decode_window``; every step's logits equal
    (JAX's test_ring_cache contract, rtol = atol = 2e-4), through the
    decode kernel in ring mode past the wrap."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.models import decode_step, init_cache, init_params

    cuda = torch.device(DEV)
    cfg = configs.get(arch)
    full = dataclasses.replace(cfg, decode_window=window,
                               **({} if cut is None else {"num_layers": cut}))
    ring = dataclasses.replace(full, ring_cache=True)
    torch.cuda.empty_cache()
    params = init_params(full, Z_SEED, device=cuda)
    toks = torch.from_numpy(np.random.default_rng(Z_SEED).integers(
        1, cfg.vocab_size, (steps, B)).astype(np.int32)).to(cuda)
    caches = {"ring": init_cache(ring, B, steps, device=cuda),
              "full": init_cache(full, B, steps, device=cuda)}
    if caches["ring"]["k"].shape[2] != min(window, steps):
        raise AssertionError(f"Z3 {arch}: ring of "
                             f"{caches['ring']['k'].shape[2]} slots")
    worst, identical = 0.0, 0
    launched = {}
    t_run = {"ring": 0.0, "full": 0.0}
    for pos in range(steps):
        logits = {}
        for name, c in (("ring", ring), ("full", full)):
            ops.reset_launches()
            t0 = time.perf_counter()
            logits[name], caches[name] = decode_step(c, params, toks[pos],
                                                     caches[name], pos)
            t_run[name] += time.perf_counter() - t0
            n = ops.launch_counts()["decode_attention"]
            launched[name] = launched.get(name, 0) + n
        a, b = logits["ring"].float(), logits["full"].float()
        if not torch.allclose(a, b, rtol=2e-4, atol=2e-4):
            raise AssertionError(
                f"Z3 {arch} pos {pos} ({'pre' if pos < window else 'post'}"
                f"-wrap): ring differs from the full cache by "
                f"{(a - b).abs().max().item():.4g}")
        worst = max(worst, (a - b).abs().max().item())
        identical += int(torch.equal(a, b))
    torch.cuda.synchronize()
    if launched["ring"] == 0:
        raise AssertionError(f"Z3 {arch}: the ring run launched no decode "
                             f"kernel")
    log(f"Z3 {full.name}{'' if cut is None else f' (depth cut to {cut})'} "
        f"B={B}: {steps} decode steps from position 0, a ring of "
        f"{caches['ring']['k'].shape[2]} slots (decode_window {window}, "
        f"wraps at {window}) against the full cache of {steps}: every step "
        f"within rtol = atol = 2e-4, max |diff| {worst:.3g}, {identical} of "
        f"{steps} steps bit-identical; decode launches ring "
        f"{launched['ring']}, full {launched['full']}; host wall ring "
        f"{t_run['ring']:.2f} s, full {t_run['full']:.2f} s (unsynchronised "
        f"enqueue of each step)")
    del params, caches
    torch.cuda.empty_cache()
    return {"decode_attention": launched["ring"] + launched["full"]}, dict(
        max_abs_diff=worst, identical_steps=identical, steps=steps)


def phase_z(torch, ops):
    """Z1-Z3 (Z4 is part of M2; see the module docstring). Returns the
    launches of the serving and ring runs (not of the checks) and the
    numbers."""
    t_phase = time.perf_counter()
    counts, results = {}, {}

    def add(c):
        for k, v in c.items():
            counts[k] = counts.get(k, 0) + v
    for arch, lengths, cut in Z_MODELS:
        c, results[arch] = z_model(torch, ops, arch, lengths, cut)
        add(c)
    for arch, window, steps, B, cut in Z_RINGS:
        c, results[f"ring_{arch}"] = z_ring(torch, ops, arch, window, steps,
                                            B, cut)
        add(c)
    log(f"Z took {time.perf_counter() - t_phase:.1f} s; launches {counts}")
    return counts, results


# ---------------------------------------------------------------------------
# Phase E: the dropless MoE's grouped expert products
# ---------------------------------------------------------------------------


def e_err(got, want):
    """max |got - want| over want's largest magnitude, both as f32."""
    want = want.float()
    return float((got.float() - want).abs().max() /
                 want.abs().max().clamp(min=1e-30))


def e_layer(torch, L, params, x, k):
    """The grouped layer (under sync debug mode "error": no host sync
    anywhere in it) and the buffer path's (``scatter`` at capacity S, the
    batched products) on ``x``; (grouped, buffer) outputs."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got, _ = L.moe(params, x, experts_per_token=k, capacity_factor=8.0)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    want, _ = L._moe_buffer(params, x, experts_per_token=k,
                            capacity_factor=8.0, dispatch="scatter")
    return got, want


def phase_e(torch, ops):
    """E1: ``csrc/moe_grouped.cu`` against its plain versions at the
    olmoe.answer.azcode cell's call shapes (OLMoE's widths, bf16), on
    skewed groups (one expert routed by every token; an expert with half
    the slots and 20 with none) and at a decode step; the grouped layer
    against the buffer path, within two bf16 roundings of the largest
    output, with no host sync. E2: each product's device time beside its
    bound and the buffer path's batched products at 131,072 slots. E3:
    one OLMoE call (16 layers, 4 x 4,096 tokens) traced: the four
    ``moe.*`` spans and ``moe.grouped`` 16 times, 32 kernel launches.
    Returns the kernel's rows (Phase K's format) and the numbers."""
    from repro_torch import configs, tracing
    from repro_torch.kernels import moe_grouped as mg
    from repro_torch.models import init_params
    from repro_torch.models import layers as L
    from repro_torch.serving.engine import ServingEngine

    t_phase = time.perf_counter()
    dev = torch.device(DEV)
    D, F, E, k = (E_WIDTHS[n] for n in ("D", "F", "E", "k"))
    gen = torch.Generator(device=dev).manual_seed(E_SEED)
    params = L.moe_init(gen, D, F, E, torch.bfloat16, dev)
    tol = 2 ** -7
    rows, res = [], {}

    def products(tag, xs, offsets):
        h = ops.moe_gate_up(xs, params["w_gate"], params["w_up"], offsets)
        h_plain = mg.gate_up_plain(xs, params["w_gate"], params["w_up"],
                                   offsets)
        y = ops.moe_down(h_plain, params["w_down"], offsets)
        y_plain = mg.down_plain(h_plain, params["w_down"], offsets)
        errs = (e_err(h, h_plain), e_err(y, y_plain))
        log(f"E1 {tag}: N={xs.shape[0]} gate/up err {errs[0]:.3e}, down err "
            f"{errs[1]:.3e} (of the largest; limit {tol:.3e})")
        if max(errs) > tol or not (torch.isfinite(h).all() and
                                   torch.isfinite(y).all()):
            raise AssertionError(f"E1 {tag}: the grouped kernel differs from "
                                 f"its plain version: {errs}")
        return max(errs)

    for B, S in E_SHAPES:
        x = torch.randn((B, S, D), generator=gen, device=dev).bfloat16()
        biased = dict(params, router=params["router"].clone())
        biased["router"][:, 3] += 0.05
        for tag, p, xx in ((f"B={B} S={S}", params, x),
                           (f"B={B} S={S} expert 3 in every token", biased,
                            x + 1)):
            gates, idx, _ = L.moe_gates(p, xx, k)
            order, offsets = L.moe_sort(idx, E)
            counts = offsets.diff()
            xs = xx.reshape(-1, D).index_select(0, order // k)
            err = products(tag, xs, offsets)
            ys = ops.moe_down(ops.moe_gate_up(xs, p["w_gate"], p["w_up"],
                                              offsets), p["w_down"], offsets)
            inv = torch.empty_like(order).scatter_(
                0, order, torch.arange(order.numel(), device=dev))
            gk = gates.reshape(-1, k)
            comb = ops.moe_combine(ys, inv, gk)
            cerr = e_err(comb, mg.combine_plain(ys, inv, gk))
            log(f"E1 {tag}: combine err {cerr:.3e}"
                f"{' (bit-identical)' if cerr == 0 else ''}")
            if cerr > tol:
                raise AssertionError(f"E1 {tag}: the combine kernel differs "
                                     f"from its plain version by {cerr}")
            got, want = e_layer(torch, L, p, xx, k)
            lerr = e_err(got, want)
            log(f"E1 {tag}: slots a expert {int(counts.min())}-"
                f"{int(counts.max())}; the grouped layer against the buffer "
                f"path {lerr:.3e} of the largest (limit {2 * tol:.3e})")
            if lerr > 2 * tol:
                raise AssertionError(f"E1 {tag}: the grouped layer differs "
                                     f"from the buffer path by {lerr}")
            rows.append(dict(key=f"OLMoE {tag} bf16", err=err))
    # skewed groups: expert 0 takes half the slots, 1-20 none, the rest
    # ragged (counts not multiples of the 128-row tile, some of one slot)
    N, empty = 16384 * k, min(20, E // 3)
    rng = torch.Generator().manual_seed(E_SEED)
    rest = torch.rand(E - 1 - empty, generator=rng) ** 3
    rest = (rest / rest.sum() * (N // 2 - (E - 1 - empty))).long() + 1
    rest[-1] += N // 2 - int(rest.sum())
    counts = torch.cat([torch.tensor([N // 2]),
                        torch.zeros(empty, dtype=torch.long), rest])
    offsets = torch.cat([torch.zeros(1, dtype=torch.long),
                         counts.cumsum(0)]).to(torch.int32).to(dev)
    xs = torch.randn((N, D), generator=gen, device=dev).bfloat16()
    err = products("skewed groups", xs, offsets)
    rows.append(dict(key=f"skewed groups N={N} bf16", err=err))

    # E2: times at the cell's 131,072 slots (B=4, S=4096)
    B, S = 4, 4096
    x = torch.randn((B, S, D), generator=gen, device=dev).bfloat16()
    _, idx, _ = L.moe_gates(params, x, k)
    order, offsets = L.moe_sort(idx, E)
    xs = x.reshape(-1, D).index_select(0, order // k)
    h = ops.moe_gate_up(xs, params["w_gate"], params["w_up"], offsets)
    N = xs.shape[0]
    b_gu = 2 * 2 * N * D * F / BF16_FLOPS * 1e3
    b_dn = 2 * N * F * D / BF16_FLOPS * 1e3
    t_gu = time_ms(torch, lambda: ops.moe_gate_up(
        xs, params["w_gate"], params["w_up"], offsets), iters=20)
    t_dn = time_ms(torch, lambda: ops.moe_down(h, params["w_down"], offsets),
                   iters=20)
    d_gu, _ = device_ms(torch, lambda: ops.moe_gate_up(
        xs, params["w_gate"], params["w_up"], offsets), "e_gate_up", iters=10)
    d_dn, _ = device_ms(torch, lambda: ops.moe_down(
        h, params["w_down"], offsets), "e_down", iters=10)
    ys = ops.moe_down(h, params["w_down"], offsets)
    inv = torch.empty_like(order).scatter_(
        0, order, torch.arange(order.numel(), device=dev))
    gk = L.moe_gates(params, x, k)[0].reshape(-1, k)
    t_cb = time_ms(torch, lambda: ops.moe_combine(ys, inv, gk), iters=20)
    t_cb_plain = time_ms(torch, lambda: mg.combine_plain(ys, inv, gk),
                         iters=5)
    b_cb = (ys.numel() * 2 + B * S * D * 2 + inv.numel() * 8 +
            gk.numel() * 4) / HBM_BYTES_PER_S * 1e3
    t_plain = time_ms(torch, lambda: mg.down_plain(mg.gate_up_plain(
        xs, params["w_gate"], params["w_up"], offsets), params["w_down"],
        offsets), iters=3, warmup=1)
    xe = torch.randn((E, B * S, D), generator=gen, device=dev).bfloat16()

    def bmm_path():
        gate = L._bmm_f32(xe, params["w_gate"])
        up = L._bmm_f32(xe, params["w_up"])
        hh = (torch.nn.functional.silu(gate) * up).to(xe.dtype)
        return L._bmm_f32(hh, params["w_down"]).to(xe.dtype)
    t_bmm = time_ms(torch, bmm_path, iters=5, warmup=1)
    del xe
    t_grouped_layer = time_ms(torch, lambda: L.moe(
        params, x, experts_per_token=k, capacity_factor=8.0), iters=10)
    t_buffer_layer = time_ms(torch, lambda: L._moe_buffer(
        params, x, experts_per_token=k, capacity_factor=8.0,
        dispatch="scatter"), iters=3, warmup=1)
    fmt = (lambda v: "not measured" if v is None else f"{v:.4f}")
    log(f"E2 B={B} S={S} N={N}: gate/up {t_gu:.4f} ms (device "
        f"{fmt(d_gu)}; bound {b_gu:.4f}, {100 * b_gu / t_gu:.1f}% of the "
        f"peak), down {t_dn:.4f} ms (device {fmt(d_dn)}; bound {b_dn:.4f}, "
        f"{100 * b_dn / t_dn:.1f}%); both {t_gu + t_dn:.4f} against "
        f"{b_gu + b_dn:.4f} ms; combine {t_cb:.4f} ms (bound {b_cb:.4f}, "
        f"bytes; plain {t_cb_plain:.4f}); plain {t_plain:.4f} ms; the "
        f"buffer path's "
        f"batched products over every slot {t_bmm:.4f} ms; the layer "
        f"grouped {t_grouped_layer:.4f} ms, buffer path {t_buffer_layer:.4f}"
        f" ms")
    res.update(combine_ms=t_cb, combine_bound_ms=b_cb,
               combine_plain_ms=t_cb_plain)
    res.update(gate_up_ms=t_gu, down_ms=t_dn, gate_up_device_ms=d_gu,
               down_device_ms=d_dn, bound_ms=b_gu + b_dn, plain_ms=t_plain,
               bmm_ms=t_bmm, layer_ms=t_grouped_layer,
               buffer_layer_ms=t_buffer_layer)
    main = dict(key=f"OLMoE B={B} S={S} N={N} bf16",
                err=max(r["err"] for r in rows),
                ms=t_gu + t_dn, plain_ms=t_plain, library_ms=t_bmm,
                bound_ms=b_gu + b_dn, bound_by="operations",
                device_ms=None if d_gu is None or d_dn is None else
                d_gu + d_dn)
    del params, x, xs, h, ys
    torch.cuda.empty_cache()

    # E3: one OLMoE call, traced
    cfg = dataclasses.replace(configs.get("olmoe-1b-7b"),
                              moe_capacity_factor=8.0)
    lm = init_params(cfg, E_SEED, device=dev)
    engine = ServingEngine(cfg, lm)
    toks = torch.randint(1, cfg.vocab_size, (4, 4096), generator=gen,
                         device=dev).int()
    engine.generate({"tokens": toks}, 1).cpu()
    torch.cuda.synchronize()
    ops.reset_launches()
    tracing.enable()
    try:
        t0 = time.perf_counter()
        engine.generate({"tokens": toks}, 1).cpu()
        dt = time.perf_counter() - t0
        trace = tracing.collect()
    finally:
        tracing.disable()
    names = {}
    for sp in trace.spans:
        if sp.name.startswith("moe."):
            names[sp.name] = names.get(sp.name, 0) + 1
    grouped = sum(n for (name, _), n in trace.counts.items()
                  if name == "moe.grouped")
    launches = ops.launch_counts()
    launches = (launches["moe_grouped"], launches["moe_combine"])
    log(f"E3 olmoe-1b-7b one call of 4 x 4096 tokens in {dt * 1e3:.1f} ms "
        f"(traced, host clock): spans {names}, moe.grouped {grouped}, "
        f"moe_grouped / moe_combine launches {launches}")
    want = {n: cfg.num_layers for n in ("moe.route", "moe.dispatch",
                                        "moe.experts", "moe.combine")}
    if names != want or grouped != cfg.num_layers or \
            launches != (2 * cfg.num_layers, cfg.num_layers):
        raise AssertionError(f"E3: spans {names}, moe.grouped {grouped}, "
                             f"launches {launches}")
    res.update(call_ms=dt * 1e3, spans=names, grouped=grouped)
    del lm, engine
    torch.cuda.empty_cache()
    log(f"E took {time.perf_counter() - t_phase:.1f} s")
    return {"moe_grouped": [main] + [dict(r, ms=None) for r in rows]}, res


# ---------------------------------------------------------------------------
# Phase T: the zoo trainer on the card; Phase D: the dry run
# ---------------------------------------------------------------------------


def recorded_train(arch, init_device=None, **kw):
    """``repro_torch.launch.train.train(arch, **kw)`` recording every
    step's metrics and the tree it saves: (its result, [per-step metrics
    as floats], the saved tree or None). With ``init_device`` the initial
    weights are drawn there and moved to the training device (a CUDA
    generator draws other numbers than the CPU's for one seed)."""
    from repro_torch.launch import train as lt
    steps, saved = [], []
    make, save, init = lt.make_train_step, lt.save_checkpoint, lt.init_params

    def make_recorded(*a, **k):
        fn = make(*a, **k)

        def step(*args):
            p, o, m = fn(*args)
            steps.append({k: float(v) for k, v in m.items()})
            return p, o, m
        return step

    def save_kept(path, tree):
        saved.append(tree)
        save(path, tree)
    def init_moved(cfg, seed, device):
        return to_device(init(cfg, seed, device=init_device), device)
    lt.make_train_step, lt.save_checkpoint = make_recorded, save_kept
    if init_device is not None:
        lt.init_params = init_moved
    try:
        out = lt.train(arch, **kw)
    finally:
        lt.make_train_step, lt.save_checkpoint = make, save
        lt.init_params = init
    return out, steps, (saved[0] if saved else None)


def t_full(torch, arch, steps, batch, seq, ckpt=None):
    """T1/T2: ``train`` at full width and depth on the card, profiled:
    every loss finite and the last below the first; ms/step, tokens/s,
    peak memory and the card's busy share. Returns (numbers, saved
    tree)."""
    import math
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    got = {}

    def run():
        got["r"] = recorded_train(arch, smoke=False, steps=steps,
                                  batch=batch, seq=seq, lr=T_LR, ckpt=ckpt,
                                  log_every=1, device=DEV)
    busy, wall = busy_ms(torch, run, f"t_{arch}")
    _, hist, saved = got["r"]
    losses = [h["loss"] for h in hist]
    if len(losses) != steps or not all(math.isfinite(x) for x in losses) \
            or not losses[-1] < losses[0]:
        raise AssertionError(f"T {arch}: losses {losses} (finite and "
                             f"falling required)")
    peak = torch.cuda.max_memory_allocated() / 1e9
    res = dict(losses=losses, ms_per_step=wall / steps,
               tokens_per_s=steps * batch * seq / (wall / 1e3),
               max_memory_gb=peak,
               busy_share=None if busy is None else busy / wall)
    log(f"T {arch}: {steps} steps at batch {batch} x seq {seq} in "
        f"{wall / 1e3:.2f} s (first step's build and warm-up included): "
        f"{res['ms_per_step']:.1f} ms/step, {res['tokens_per_s']:.0f} "
        f"tokens/s; losses {[round(x, 4) for x in losses]}; "
        f"max_memory_allocated {peak:.2f} GB; card busy "
        f"{'not measured' if busy is None else f'{busy:.1f} ms of {wall:.1f} ms ({100 * busy / wall:.1f}%)'}")
    return res, saved


def phase_t(torch, ops):
    """T1: olmo-1b trained at full width and depth, its checkpoint
    reloaded bit for bit and served (Phase Z's serving run and logit
    checks on the trained weights: flash and decode launch); T2:
    whisper-medium at full width and depth; T3: every arch's smoke config
    on the card and on the CPU from one init (the CPU's draw of seed 0),
    every step's loss within T3_TOL relative.
    Returns the launches of T1's serving run and the numbers."""
    from repro_torch import configs
    from repro_torch.launch.train import tensor_name
    from repro_torch.training import load_checkpoint
    t_phase = time.perf_counter()
    results = {}
    arch, steps, batch, seq = T1
    ckpt = ROOT / "build" / "phase_t" / "olmo.npz"
    results[arch], saved = t_full(torch, arch, steps, batch, seq, str(ckpt))
    back = load_checkpoint(str(ckpt), device=DEV)
    from repro_torch.tree import leaves
    if tensor_name(back["cfg_name"].cpu()) != configs.get(arch).name or \
            len(leaves(back["params"])) != len(leaves(saved["params"])) or \
            not all(torch.equal(a, b) for a, b in zip(
                leaves(back["params"]), leaves(saved["params"]))):
        raise AssertionError("T1: the checkpoint does not reload bit for "
                             "bit")
    log(f"T1 checkpoint {ckpt.stat().st_size / 1e9:.2f} GB reloads bit for "
        f"bit ({len(leaves(back['params']))} leaves)")
    del saved
    counts, results["serve"] = z_model(torch, ops, arch, T1_PROMPTS,
                                       params=back["params"])
    del back
    torch.cuda.empty_cache()
    arch, steps, batch, seq = T2
    results[arch], _ = t_full(torch, arch, steps, batch, seq)
    for arch in configs.all_archs():
        runs = [recorded_train(arch, init_device="cpu", smoke=True,
                               steps=T3[0], batch=T3[1], seq=T3[2], lr=T_LR,
                               ckpt=None, log_every=T3[0], device=dev)[1]
                for dev in (DEV, "cpu")]
        card, cpu = ([h["loss"] for h in r] for r in runs)
        rel = max(abs(a - b) / abs(b) for a, b in zip(card, cpu))
        if not rel <= T3_TOL:
            raise AssertionError(f"T3 {arch}: card losses {card} against "
                                 f"the CPU's {cpu} (rel {rel:.3g})")
        log(f"T3 {arch}: {T3[0]} smoke steps, card == CPU within {rel:.2g} "
            f"relative (<= {T3_TOL}); losses {[round(x, 5) for x in card]}")
        results[f"smoke_{arch}"] = rel
    log(f"T took {time.perf_counter() - t_phase:.1f} s; launches {counts}")
    return counts, results


def phase_d():
    """The dry run on this machine's torch: ``python -m
    repro_torch.launch.dryrun`` for each of D_CASES, a process each, side
    by side, without the card. Every pair must be ``ok``, whisper-medium
    ``train_4k`` (which the JAX package fails) ``ok`` or ``FAILED`` as
    ROADMAP.md records. Prints each pair's roofline terms and its
    arguments per device against one card's memory."""
    import os
    t_phase = time.perf_counter()
    out_dir = ROOT / "build" / "phase_d"
    out_dir.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
               PYTHONPATH=str(ROOT / "src"))
    procs = []
    for i, (arch, shape, mp) in enumerate(D_CASES):
        out = out_dir / f"dr{i}.json"
        out.unlink(missing_ok=True)
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape, "--out", str(out)]
        procs.append((arch, shape, mp, out, subprocess.Popen(
            cmd + (["--multi-pod"] if mp else []), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, env=env)))
    results, failed = {}, []
    try:
        for arch, shape, mp, out, p in procs:
            text, _ = p.communicate(timeout=D_TIMEOUT_S)
            if p.returncode != 0:
                failed.append(f"D {arch} {shape}: exit {p.returncode}: "
                              f"{text[-3000:]}")
                continue
            (rec,) = json.loads(out.read_text())
            results[(arch, shape, mp)] = rec
            mesh = "2x16x16" if mp else "16x16"
            if rec["status"] != "ok":
                log(f"D {arch} {shape} {mesh}: {rec['status']} "
                    f"({rec.get('error')})\n{rec.get('traceback', '')}")
                if (arch, shape) != ("whisper-medium", "train_4k"):
                    failed.append(f"D {arch} {shape} {mesh}: "
                                  f"{rec['status']}")
                continue
            r, m = rec["roofline"], rec["memory"]
            log(f"D {arch} {shape} {mesh}: compute "
                f"{r['compute_s'] * 1e3:.3f} ms, memory "
                f"{r['memory_s'] * 1e3:.3f} ms, collective "
                f"{r['collective_s'] * 1e3:.3f} ms, dominant "
                f"{r['dominant']}; arguments "
                f"{m['argument_bytes'] / 1e9:.3f} GB/device of 80 GB; "
                f"counted/analytic FLOPs "
                f"{r['flops_per_device'] / rec['analytic']['flops_per_device']:.3f}"
                f"; replicated ops {rec['replicated_ops']}; ran "
                f"{rec['compile_s']} s")
    finally:
        for *_, p in procs:
            p.kill()
            p.wait()
    if failed:
        raise AssertionError("; ".join(failed))
    log(f"D took {time.perf_counter() - t_phase:.1f} s")
    return results


# ---------------------------------------------------------------------------
# Phase S: the trained system on the card
# ---------------------------------------------------------------------------


def s0_train_parity(torch):
    """S0: the same train steps from the same init on the card and on the
    CPU: rar-weak's AdamW step and the embedder's Adam step, on the same
    numpy batches. Returns the trajectories."""
    import numpy as np

    from repro_torch.configs import rar_system
    from repro_torch.core import embedder
    from repro_torch.data.tasks import TaskSuite
    from repro_torch.experiments.setup import lm_optimizer
    from repro_torch.models import init_params
    from repro_torch.training import init_opt_state, make_train_step
    from repro_torch.tree import leaves

    cuda, cpu = torch.device(DEV), torch.device("cpu")
    suite = TaskSuite()
    out = {}

    def compare(tag, run, params):
        """``run(params, device, rng)`` -> (params, losses) on both."""
        (pc, lc), (ph, lh) = (run(to_device(params, dev), dev,
                                  np.random.default_rng(SEEDS["weak"]))
                              for dev in (cuda, cpu))
        rel = max(abs(a - b) / abs(b) for a, b in zip(lc, lh))
        pairs = [(a.cpu(), b) for a, b in zip(leaves(pc), leaves(ph))]
        err = max((a - b).abs().max().item() for a, b in pairs)
        # the parameters' difference against how far training moved them,
        # over the whole tree (one weight whose gradient is within rounding
        # of zero may take a different Adam step of up to the learning
        # rate on either device; the max element difference is printed)
        moved = sum((b - a0.cpu()).square().sum().item() for (_, b), a0 in
                    zip(pairs, leaves(params))) ** 0.5
        prel = sum((a - b).square().sum().item() for a, b in pairs) ** 0.5 \
            / moved
        log(f"S0 {tag}: {S0_STEPS} steps, losses card "
            f"{[round(x, 7) for x in lc]}, CPU {[round(x, 7) for x in lh]}; "
            f"max relative loss difference {rel:.3e} (tolerance "
            f"{S0_LOSS_TOL}); parameters: L2 difference {prel:.3e} of the "
            f"L2 distance trained (tolerance {S0_PARAM_TOL}), max element "
            f"difference {err:.3e}")
        if not rel <= S0_LOSS_TOL or not prel <= S0_PARAM_TOL:
            raise AssertionError(f"S0 {tag}: card and CPU training differ")
        out[tag] = dict(card=lc, cpu=lh, loss_rel=rel, param_rel=prel,
                        param_max_err=err)

    def lm_run(params, dev, rng):
        step = make_train_step(rar_system.WEAK, lm_optimizer(900))
        opt, losses = init_opt_state(params), []
        for _ in range(S0_STEPS):
            params, opt, m = step(params, opt, suite.weak_train_batch(rng, 96))
            losses.append(float(m["loss"]))
        return params, losses

    def emb_run(params, dev, rng):
        step = embedder.make_train_step(rar_system.EMBEDDER)
        opt, losses = embedder.init_opt(params), []
        for _ in range(S0_STEPS):
            toks, sids = suite.embedder_batch(rng, 48)
            params, opt, loss = step(params, opt, toks, sids)
            losses.append(float(loss))
        return params, losses

    compare("rar-weak AdamW", lm_run,
            init_params(rar_system.WEAK, SEEDS["weak"], device=cuda))
    compare("embedder Adam", emb_run,
            embedder.init_params(rar_system.EMBEDDER, SEEDS["embedder"],
                                 device=cuda))
    return out


def premise(system):
    """``tests/test_system.py``'s capability check: accuracies of strong on
    all skills, weak on its known and unknown skills, weak guided."""
    import numpy as np
    suite = system.suite
    rng = np.random.default_rng(0)

    def acc(tier, skills, guided=False, n=80):
        prompts, truth = [], []
        for _ in range(n):
            s = int(rng.choice(skills))
            d, x = suite.domain_of(s), int(rng.integers(0, 100))
            g = suite.guide(s) if guided else None
            prompts.append(np.asarray(suite.vocab.question(d, s, x, g),
                                      np.int32))
            truth.append(suite.answer(s, x))
        ans = tier.answer_batch(np.stack(prompts))
        return float((ans == np.asarray(truth)).mean())

    all_sk = np.arange(suite.cfg.total_skills)
    unknown = np.setdiff1d(all_sk, suite.weak_known)
    return {"strong_all": acc(system.strong, all_sk),
            "weak_known": acc(system.weak, suite.weak_known),
            "weak_unknown": acc(system.weak, unknown),
            "weak_unknown_guided": acc(system.weak, unknown, guided=True),
            "weak_unknown_again": acc(system.weak, unknown)}


def rows(results):
    return [dataclasses.astuple(r) for r in results]


def dict_rows(results):
    return [dataclasses.asdict(r) for r in results]


def fig4_summary(runs, base) -> dict:
    """``benchmarks/fig4_rar_vs_baselines.py``'s four headline ratios over
    ``runs`` (per-stage rows of each shuffle, as dicts) against ``base``
    (``run_baselines``' rows by method)."""
    n_total = len(runs[0]) * runs[0][0]["n"]
    strong = sum(sum(r["strong_calls"] for r in run) for run in runs) \
        / len(runs)
    aligned = sum(sum(r["aligned"] for r in run) for run in runs) / len(runs)
    return {
        "strong_call_reduction_vs_oracle": 1.0 - strong / max(
            sum(r["strong_calls"] for r in base["oracle_router"]), 1),
        "quality_vs_oracle": aligned / n_total,
        "aligned_vs_weak": aligned / max(
            sum(r["aligned"] for r in base["weak"]), 1),
        "aligned_vs_cot": aligned / max(
            sum(r["aligned"] for r in base["weak_cot"]), 1)}


def fig7_split(runs) -> dict:
    """``benchmarks/fig7_guide_memory.py``'s aligned guided responses a
    stage by guide source, the mean over ``runs``."""
    n = len(runs)
    mem = [sum(run[i]["guides_from_memory"] for run in runs) / n
           for i in range(len(runs[0]))]
    fresh = [sum(run[i]["guides_fresh"] for run in runs) / n
             for i in range(len(runs[0]))]
    return {"memory_per_stage": mem, "fresh_per_stage": fresh,
            "memory_total": sum(mem), "fresh_total": sum(fresh)}


def pool_margins(torch, system, pool):
    """How far the pool sits from a flip: the smallest top-2 logit gap of
    the tiers' first answer token over its prompts (and the strong tier's
    over its guide requests), and the closest pairwise embedding
    similarity to the 0.6 routing threshold."""
    import numpy as np

    from repro_torch.experiments.stages import _prompts
    prompts, greqs = _prompts(system, pool)
    gap = min_logit_gap(torch, (system.weak.engine.params,
                                system.strong.engine.params), prompts,
                        greqs, system.weak.engine.device)
    e = system.embed_many(prompts)
    sims = e @ e.T
    np.fill_diagonal(sims, 0.0)
    return gap, float(np.abs(sims - 0.6).min())


def t1_populate(system, pool):
    """``populate_memory`` of ``benchmarks/table1_generalization.py``: a
    standard RAR run (2 stages, seed 0) over ``pool``; its guide memory."""
    from repro_torch.experiments.stages import run_rar_experiment
    _, rar = run_rar_experiment(system, pool, n_stages=2, seed=0,
                                device=system.weak.engine.device)
    return rar.memory


def t1_guided_eval(system, pool, memory):
    """``guided_eval`` of ``benchmarks/table1_generalization.py`` over the
    port: the weak tier answers each question with the guide read from
    ``memory`` (guides only, kept at similarity >= 0.1). Returns the count
    aligned with the strong tier, a ``[row, sim, guided, weak answer]``
    row a question, and the strong tier's answers."""
    import numpy as np

    from repro_torch.core import memory as mem
    from repro_torch.experiments.stages import _batched_answers, _prompts
    prompts, _ = _prompts(system, pool)
    strong_ref = _batched_answers(system.strong, prompts)
    embs = system.embed_many(prompts)
    guided, reads = [], []
    for p, e in zip(prompts, embs):
        q = mem.query(memory, e, guides_only=True)
        sim = float(q.sim)
        reads.append([int(q.index), sim, sim >= T1_THRESHOLD])
        if sim >= T1_THRESHOLD:
            g = q.guide.cpu().numpy()
            g = g[g != 0]
            guided.append(np.concatenate([p[:1], g, p[1:]]).astype(np.int32))
        else:
            guided.append(p)
    ans = np.zeros(len(pool), np.int64)
    for ln in {len(p) for p in guided}:
        idx = [i for i, p in enumerate(guided) if len(p) == ln]
        ans[idx] = system.weak.answer_batch(np.stack([guided[i]
                                                      for i in idx]))
    for r, a in zip(reads, ans):
        r.append(int(a))
    aligned = int(np.sum((ans == strong_ref) & (ans >= 0)))
    return aligned, reads, [int(a) for a in strong_ref]


def table1(system, source, targets: dict) -> dict:
    """Table I as ``benchmarks/table1_generalization.py``'s ``main`` runs
    it: guides of a memory populated on ``source`` (domain 0) read for each
    of ``targets`` ({domain: pool}) beside its own memory's and none; the
    record's layout (``scripts/export_jax_domains.py``)."""
    import numpy as np

    from repro_torch.experiments.setup import POOL_NAMES
    from repro_torch.experiments.stages import _batched_answers, _prompts
    src_memory = t1_populate(system, source)
    out, rows, sims = {}, [], []
    for d, pool in targets.items():
        n, name = len(pool), POOL_NAMES[d]
        prompts, _ = _prompts(system, pool)
        inter, inter_reads, strong = t1_guided_eval(system, pool, src_memory)
        intra, intra_reads, _ = t1_guided_eval(system, pool,
                                               t1_populate(system, pool))
        weak = _batched_answers(system.weak, prompts)
        unguided = int(np.sum((weak == np.asarray(strong)) & (weak >= 0)))
        sims += [r[1] for r in inter_reads + intra_reads]
        rows += [{"target": name, "guide_source": g,
                  "diff_from_strong_pct": round(100.0 * (n - a) / n, 1)}
                 for g, a in ((POOL_NAMES[0], inter), (name, intra),
                              ("unguided", unguided))]
        out[str(d)] = dict(target=name, n=n, inter=inter, intra=intra,
                           unguided=unguided, strong=strong,
                           reads={"inter": inter_reads,
                                  "intra": intra_reads})
    return dict(source_domain=0, source_n=len(source), source_stages=2,
                xfer_threshold=T1_THRESHOLD, targets=out, rows=rows,
                threshold_margin=float(np.abs(np.asarray(sims)
                                              - T1_THRESHOLD).min()))


def t1_faults(got: dict, want: dict, sim_tol: float) -> list[str]:
    """Where a Table I run differs from the record: counts, the
    percentages, the strong answers, and each read's row, guided flag and
    weak answer exactly, its similarity within ``sim_tol``."""
    faults = []
    if got["rows"] != want["rows"]:
        faults.append(f"rows {got['rows']} vs {want['rows']}")
    for d, w in want["targets"].items():
        g = got["targets"][d]
        for k in ("n", "inter", "intra", "unguided", "strong"):
            if g[k] != w[k]:
                faults.append(f"target {d} {k} differs" + (
                    "" if k == "strong" else f": {g[k]} vs {w[k]}"))
        for tag, want_reads in w["reads"].items():
            if len(g["reads"][tag]) != len(want_reads):
                faults.append(f"target {d} {tag}: {len(g['reads'][tag])} "
                              f"reads, not {len(want_reads)}")
            for i, (a, b) in enumerate(zip(g["reads"][tag], want_reads)):
                if [a[0], a[2], a[3]] != [b[0], b[2], b[3]] or \
                        abs(a[1] - b[1]) > sim_tol:
                    faults.append(f"target {d} {tag} question {i}: "
                                  f"[row, sim, guided, weak] {a} vs {b}")
                    break
    return faults


def phase_s(torch, ops):
    from repro_torch.experiments import setup, stages

    cuda, cpu = torch.device(DEV), torch.device("cpu")
    results = {"S0": s0_train_parity(torch)}

    # S1: train the whole system on the card at the JAX package's defaults
    ops.reset_launches()
    t0 = time.perf_counter()
    system = setup.build_system(device=cuda, cache=False, verbose=True)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    st = system.train_stats
    log(f"S1 build_system on the card ({card_line()}): {total:.1f} s in all; "
        + "; ".join(f"{k} {v['seconds']:.1f} s" +
                    (f", {v['steps']} steps, loss {v['loss']:.4f}"
                     if "steps" in v else
                     f", {v['n_profile']} profiled prompts") +
                    (f", accuracy {v['accuracy']:.4f}"
                     if v.get("accuracy") is not None else "")
                    for k, v in st.items()))
    results["S1"] = dict(seconds=total, **st)

    # S2: the premise the method needs (test_system.py's thresholds)
    acc = premise(system)
    log(f"S2 premise on the card-trained system: {acc}")
    if not (acc["strong_all"] > 0.9 and acc["weak_known"] > 0.75
            and acc["weak_unknown"] < 0.55 and acc["weak_unknown_guided"] >
            acc["weak_unknown_again"] + 0.25):
        raise AssertionError(f"S2: premise fails: {acc}")
    results["S2"] = acc

    # S3: the card-trained system copied to the CPU serves alike
    host = setup.build_system(device=cpu, verbose=False, params={
        "weak": to_device(system.weak.engine.params, cpu),
        "strong": to_device(system.strong.engine.params, cpu),
        "embedder": to_device(system.embedder_params, cpu),
        "router_w": system.router.w.cpu(), "router_b": system.router.b.cpu()})
    t0 = time.perf_counter()
    pool = setup.failing_pool(system, domain=0, n=S3_POOL)
    if pool != setup.failing_pool(host, domain=0, n=S3_POOL):
        raise AssertionError("S3: failing pools differ card vs CPU")
    gap, margin = pool_margins(torch, system, pool)
    log(f"S3 failing_pool(domain=0, n={S3_POOL}) card == CPU; smallest "
        f"top-2 logit gap over its prompts {gap:.6f}; closest pairwise sim "
        f"to the 0.6 threshold {margin:.4f} away")
    s3 = {}
    for tag, kw in S3_RUNS.items():
        c, c_rar = stages.run_rar_experiment(system, pool, n_stages=3, seed=0,
                                             device=cuda, **kw)
        h, _ = stages.run_rar_experiment(host, pool, n_stages=3, seed=0,
                                         device=cpu, **kw)
        if rows(c) != rows(h):
            raise AssertionError(f"S3 {tag}: StageResults differ card vs CPU:"
                                 f" {rows(c)} vs {rows(h)}")
        log(f"S3 {tag}: StageResults card == CPU: {rows(c)}")
        s3[tag] = (c, c_rar)
    base = stages.run_baselines(system, pool, n_stages=3)
    host_base = stages.run_baselines(host, pool, n_stages=3)
    if {k: rows(v) for k, v in base.items()} != \
            {k: rows(v) for k, v in host_base.items()}:
        raise AssertionError("S3: baselines differ card vs CPU")
    log(f"S3 run_baselines card == CPU: "
        f"{ {k: rows(v)[0] for k, v in base.items()} }")
    seq = s3["mb1"][0]
    n = 3 * len(pool)
    quality = sum(r.aligned for r in seq) / n
    checks = {
        "last stage strong < 0.6 x first":
            seq[-1].strong_calls < 0.6 * seq[0].strong_calls,
        "last stage strong < 0.6 x pool":
            seq[-1].strong_calls < 0.6 * len(pool),
        "quality > 0.75": quality > 0.75,
        "beats weak": sum(r.aligned for r in seq) >
            sum(r.aligned for r in base["weak"]),
        "beats CoT": sum(r.aligned for r in seq) >
            sum(r.aligned for r in base["weak_cot"]),
        "fewer strong calls than the oracle router":
            sum(r.strong_calls for r in seq) <
            sum(r.strong_calls for r in base["oracle_router"]),
    }
    log(f"S3 claims on the card's sequential run (quality {quality:.4f}): "
        f"{checks}; S3 took {time.perf_counter() - t0:.1f} s (card and CPU "
        f"runs)")
    if not all(checks.values()):
        raise AssertionError(f"S3: a claim fails: {checks}")
    results["S3"] = {k: rows(v[0]) for k, v in s3.items()}

    # S4: the fig4 shape on the card
    t0 = time.perf_counter()
    pool = setup.failing_pool(system, domain=0)
    t1 = time.perf_counter()
    rar_res, _ = stages.run_rar_experiment(
        system, pool, n_stages=FIG4_STAGES, seed=0, microbatch=FIG4_MB,
        device=cuda, verbose=True)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    base = stages.run_baselines(system, pool, n_stages=FIG4_STAGES)
    n_total = FIG4_STAGES * len(pool)
    fig4 = fig4_summary([dict_rows(rar_res)],
                        {k: dict_rows(v) for k, v in base.items()})
    log(f"S4 fig4 on the card: {setup.POOL_NAMES[0]} pool n={len(pool)} "
        f"(pool built in {t1 - t0:.1f} s), {FIG4_STAGES} stages x 1 shuffle,"
        f" microbatch {FIG4_MB}: per-stage strong calls "
        f"{[r.strong_calls for r in rar_res]}, aligned "
        f"{[r.aligned for r in rar_res]}; {n_total / (t2 - t1):.1f} "
        f"requests/s over the stages; strong-call reduction vs the oracle "
        f"router {fig4['strong_call_reduction_vs_oracle'] * 100:.1f}% "
        f"(paper 50.2%), quality {fig4['quality_vs_oracle'] * 100:.1f}% "
        f"(paper 90.5%), aligned x{fig4['aligned_vs_weak']:.2f} vs weak "
        f"(paper +349%), x{fig4['aligned_vs_cot']:.2f} vs CoT (paper "
        f"+135%)")
    results["S4"] = dict(fig4, strong_calls=[r.strong_calls for r in rar_res],
                         aligned=[r.aligned for r in rar_res],
                         req_per_s=n_total / (t2 - t1))
    results["system"] = system

    counts = ops.launch_counts()
    log(f"S launches on the card (S1-S4): {counts}")
    for k in ("memory_topk", "flash_attention", "decode_attention"):
        if counts[k] == 0:
            raise AssertionError(f"Phase S never launched {k}")
    return counts, results


# ---------------------------------------------------------------------------
# Phase P: the paper's fig4/fig7 runs against the JAX package's record
# ---------------------------------------------------------------------------


def p_kwargs(run: dict) -> dict:
    """A recorded run's ``run_rar_experiment`` arguments (k = 1 is the
    default top-1 read, as ``benchmarks/common.py`` passes it)."""
    k = run["retrieval_k"]
    return dict(n_stages=run["n_stages"], seed=run["seed"],
                microbatch=run["microbatch"],
                retrieval_k=None if k == 1 else k)


def reference_system(torch):
    """The JAX package's trained system (``reference/jax_rar_system.npz``)
    bridged onto the card."""
    from repro_torch import bridge
    from repro_torch.experiments import setup
    from repro_torch.training.checkpoint import load_checkpoint
    blob = load_checkpoint(str(REFERENCE / "jax_rar_system.npz"),
                           device="cpu")
    return setup.build_system(device=torch.device(DEV), cache=False,
                              verbose=False,
                              params=bridge.system(blob, device=DEV))


def phase_p(torch, ops):
    """The JAX package's trained system (``reference/jax_rar_system.npz``)
    on the card, held to the JAX package's own runs on it
    (``reference/jax_fig4_fig7.json``, written by
    ``scripts/export_jax_reference.py`` on the CPU): equal failing pool
    (P1), baselines (P2), every ``StageResult`` of the sequential runs
    (P3) and the microbatch-16 runs (P4)."""
    from repro_torch.experiments import setup, stages
    from repro_torch.kernels import memory_topk as mt

    cuda = torch.device(DEV)
    t_phase = time.perf_counter()
    record = json.loads((REFERENCE / "jax_fig4_fig7.json").read_text())

    # the store reads' (B, k) a launch, beside the wrapper's own count
    shapes: dict = {}
    topk_cuda = mt.memory_topk_batch_padded_cuda

    def noting(mem, qs, mask, k, required=mt.MASK_VALID):
        key = (int(qs.shape[0]), int(k))
        shapes[key] = shapes.get(key, 0) + 1
        return topk_cuda(mem, qs, mask, k, required)

    mt.memory_topk_batch_padded_cuda = noting
    ops.reset_launches()
    try:
        system = reference_system(torch)
        faults = []

        # P1: the failing pool
        pool = setup.failing_pool(system, domain=record["domain"],
                                  n=len(record["pool"]))
        gap, margin = pool_margins(torch, system, pool)
        rec_m = record["margins"]
        margins = (f"card: smallest top-2 logit gap {gap:.6f}, closest "
                   f"pairwise sim to 0.6 {margin:.3e} away; JAX record: "
                   f"{rec_m['logit_gap']:.6f} (relative "
                   f"{rec_m['logit_gap_rel']:.3e}), "
                   f"{rec_m['threshold_margin']:.3e}")
        want_pool = [tuple(c) for c in record["pool"]]
        if pool != want_pool:
            i = next((j for j, (a, b) in enumerate(zip(pool, want_pool))
                      if a != b), min(len(pool), len(want_pool)))
            faults.append(f"P1 failing pool differs from question {i}")
            log(f"P1 MISMATCH failing_pool(domain={record['domain']}, "
                f"n={len(want_pool)}) from question {i}: card "
                f"{pool[i:i + 3]} vs JAX {want_pool[i:i + 3]}; {margins}")
        else:
            log(f"P1 failing_pool(domain={record['domain']}, "
                f"n={len(pool)}) card == JAX record; {margins}")

        # P2: the baselines
        base = {k: dict_rows(v) for k, v in stages.run_baselines(
            system, want_pool, n_stages=FIG4_STAGES).items()}

        def firsts(b):
            return {k: (v[0]["aligned"], v[0]["strong_calls"])
                    for k, v in b.items()}
        if base != record["baselines"]:
            faults.append("P2 baselines differ")
            log(f"P2 MISMATCH run_baselines, (aligned, strong calls) of a "
                f"stage: card {firsts(base)} vs JAX "
                f"{firsts(record['baselines'])}; {margins}")
        else:
            log(f"P2 run_baselines(n_stages={FIG4_STAGES}) card == JAX "
                f"record, (aligned, strong calls) of a stage: "
                f"{firsts(base)}")

        # P3 (sequential) and P4 (microbatch 16): every recorded run
        card_runs, rates = {}, {}
        for name, run in record["runs"].items():
            tag = "P3" if run["microbatch"] == 1 else "P4"
            t0 = time.perf_counter()
            res, _ = stages.run_rar_experiment(
                system, want_pool[:run["pool_n"]], device=cuda,
                **p_kwargs(run))
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            got = dict_rows(res)
            card_runs[name] = got
            rates[name] = run["pool_n"] * run["n_stages"] / dt
            diff = next((i for i, (g, w) in enumerate(
                zip(got, run["stages"])) if g != w), None)
            what = (f"{name} (pool {run['pool_n']}, {run['n_stages']} "
                    f"stages, seed {run['seed']}, microbatch "
                    f"{run['microbatch']}, retrieval_k {run['retrieval_k']})")
            if diff is not None:
                faults.append(f"{tag} {name} differs from stage {diff + 1}")
                log(f"{tag} MISMATCH {what} at stage {diff + 1}: card "
                    f"{got[diff]} vs JAX {run['stages'][diff]}; {margins}")
            else:
                log(f"{tag} {what}: every StageResult card == JAX record; "
                    f"strong calls {[r['strong_calls'] for r in got]}, "
                    f"aligned {[r['aligned'] for r in got]}; "
                    f"{rates[name]:.1f} requests/s on the card (JAX on "
                    f"the CPU: {run['cpu_requests_per_s']:.1f})")

        # fig4's ratios and fig7's split: the card's, the record's, the
        # paper's
        for k in (1, 4):
            seq = [card_runs[n] for n, r in record["runs"].items()
                   if r["microbatch"] == 1 and r["retrieval_k"] == k]
            f4, f7 = fig4_summary(seq, base), fig7_split(seq)
            rf4, rf7 = record["fig4"][f"k{k}"], record["fig7"][f"k{k}"]
            log(f"P fig4 k={k} over {len(seq)} shuffles, card / JAX record "
                f"/ paper: strong-call reduction vs the oracle router "
                f"{f4['strong_call_reduction_vs_oracle'] * 100:.2f}% / "
                f"{rf4['strong_call_reduction_vs_oracle'] * 100:.2f}% / "
                f"50.2%; quality {f4['quality_vs_oracle'] * 100:.2f}% / "
                f"{rf4['quality_vs_oracle'] * 100:.2f}% / 90.5%; aligned "
                f"x{f4['aligned_vs_weak']:.2f} / "
                f"x{rf4['aligned_vs_weak']:.2f} vs weak (paper +349%); "
                f"x{f4['aligned_vs_cot']:.3f} / x{rf4['aligned_vs_cot']:.3f}"
                f" vs CoT (paper +135%)")
            log(f"P fig7 k={k}, aligned guided responses a stage via "
                f"memory / fresh, card: {f7['memory_per_stage']} / "
                f"{f7['fresh_per_stage']}; JAX record: "
                f"{rf7['memory_per_stage']} / {rf7['fresh_per_stage']}")
    finally:
        mt.memory_topk_batch_padded_cuda = topk_cuda

    counts = ops.launch_counts()
    seconds = time.perf_counter() - t_phase
    log(f"P launches on the card: {counts}; memory_topk by (B, k): "
        f"{dict(sorted(shapes.items()))}; Phase P took {seconds:.1f} s")
    for k in ("memory_topk", "flash_attention", "decode_attention"):
        if counts[k] == 0:
            faults.append(f"P never launched {k}")
    for what, hit in (("B=1", any(b == 1 for b, _ in shapes)),
                      ("B=16", any(b == 16 for b, _ in shapes)),
                      ("k=4", any(k == 4 for _, k in shapes))):
        if not hit:
            faults.append(f"P never launched memory_topk at {what}")
    if faults:
        raise AssertionError(f"Phase P: {faults}")
    return counts, dict(runs=card_runs, rates=rates, seconds=seconds,
                        system=system)


# ---------------------------------------------------------------------------
# Phase G: the paper's fig5, fig6 and Table I against the JAX package's record
# ---------------------------------------------------------------------------


def phase_g(torch, ops, system):
    """The JAX package's runs of fig6 (domain 1), fig5 (domain 2) and Table
    I on the exported system (``reference/jax_fig5_fig6_table1.json``,
    written by ``scripts/export_jax_domains.py`` on the CPU), replayed on
    Phase P's bridged ``system``: equal failing pools (G1), baselines (G2),
    every ``StageResult`` of the sequential runs (G3) and the microbatch-16
    runs (G4), and Table I (G5: counts, percentages, and each question's
    retrieved row, guided flag and weak answer; its similarity within
    G_SIM_TOL)."""
    from repro_torch.experiments import setup, stages
    from repro_torch.kernels import memory_topk as mt

    cuda = torch.device(DEV)
    t_phase = time.perf_counter()
    record = json.loads((REFERENCE / "jax_fig5_fig6_table1.json")
                        .read_text())
    source = [tuple(c) for c in json.loads(
        (REFERENCE / "jax_fig4_fig7.json").read_text())["pool"]]

    # the store reads' (kernel, B, k, required) a launch
    shapes: dict = {}
    topk_cuda, top1_cuda = (mt.memory_topk_batch_padded_cuda,
                            mt.memory_top1_batch_padded_cuda)

    def note(key):
        shapes[key] = shapes.get(key, 0) + 1

    def topk(mem, qs, mask, k, required=mt.MASK_VALID):
        note(("memory_topk", int(qs.shape[0]), int(k), int(required)))
        return topk_cuda(mem, qs, mask, k, required)

    def top1(mem, qs, mask, required=mt.MASK_VALID):
        note(("memory_top1", int(qs.shape[0]), 1, int(required)))
        return top1_cuda(mem, qs, mask, required)

    def firsts(b):
        return {k: (v[0]["aligned"], v[0]["strong_calls"])
                for k, v in b.items()}

    mt.memory_topk_batch_padded_cuda = topk
    mt.memory_top1_batch_padded_cuda = top1
    ops.reset_launches()
    faults, pools, rates, summary = [], {}, {}, {}
    try:
        for d in G_DOMAINS:
            rec = record["domains"][str(d)]
            fig = f"{rec['figure']} ({rec['pool_name']}, domain {d})"

            # G1: the failing pool and its margins
            pool = setup.failing_pool(system, domain=d)
            want = [tuple(c) for c in rec["pool"]]
            pools[d] = want
            gap, margin = pool_margins(torch, system, want)
            rm = rec["margins"]
            margins = (f"card: smallest top-2 logit gap {gap:.6f}, closest "
                       f"pairwise sim to 0.6 {margin:.3e} away; JAX record: "
                       f"{rm['logit_gap']:.6f} (relative "
                       f"{rm['logit_gap_rel']:.3e}), "
                       f"{rm['threshold_margin']:.3e}")
            if pool != want:
                i = next((j for j, (a, b) in enumerate(zip(pool, want))
                          if a != b), min(len(pool), len(want)))
                faults.append(f"G1 {fig} failing pool differs from "
                              f"question {i}")
                log(f"G1 MISMATCH {fig} failing pool from question {i}: "
                    f"card {pool[i:i + 3]} vs JAX {want[i:i + 3]}; {margins}")
            else:
                log(f"G1 {fig}: failing_pool (n={len(pool)}) card == JAX "
                    f"record; {margins}")

            # G2: the baselines
            base = {k: dict_rows(v) for k, v in stages.run_baselines(
                system, want, n_stages=FIG4_STAGES).items()}
            if base != rec["baselines"]:
                faults.append(f"G2 {fig} baselines differ")
                log(f"G2 MISMATCH {fig} run_baselines, (aligned, strong "
                    f"calls) of a stage: card {firsts(base)} vs JAX "
                    f"{firsts(rec['baselines'])}; {margins}")
            else:
                log(f"G2 {fig} run_baselines(n_stages={FIG4_STAGES}) card "
                    f"== JAX record, (aligned, strong calls) of a stage: "
                    f"{firsts(base)}")

            # G3 (sequential) and G4 (microbatch 16)
            for name, run in rec["runs"].items():
                tag = "G3" if run["microbatch"] == 1 else "G4"
                t0 = time.perf_counter()
                res, _ = stages.run_rar_experiment(system, want, device=cuda,
                                                   **p_kwargs(run))
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                got = dict_rows(res)
                rates[(d, name)] = run["pool_n"] * run["n_stages"] / dt
                what = (f"{fig} {name} ({run['pool_n']} questions, "
                        f"{run['n_stages']} stages, seed {run['seed']}, "
                        f"microbatch {run['microbatch']}, retrieval_k "
                        f"{run['retrieval_k']})")
                diff = next((i for i, (g, w) in enumerate(
                    zip(got, run["stages"])) if g != w), None)
                if diff is not None:
                    faults.append(f"{tag} {fig} {name} differs from stage "
                                  f"{diff + 1}")
                    log(f"{tag} MISMATCH {what} at stage {diff + 1}: card "
                        f"{got[diff]} vs JAX {run['stages'][diff]}; "
                        f"{margins}")
                    continue
                log(f"{tag} {what}: every StageResult card == JAX record; "
                    f"strong calls {[r['strong_calls'] for r in got]}, "
                    f"aligned {[r['aligned'] for r in got]}; "
                    f"{rates[(d, name)]:.1f} requests/s on the card (JAX on "
                    f"the CPU: {run['cpu_requests_per_s']:.1f})")
                if name == "seq_seed0_k1":
                    f4, rf4 = fig4_summary([got], base), rec["fig4"]
                    summary[d] = f4
                    log(f"G {rec['figure']} summary, card / JAX record / "
                        f"paper (fig4's): strong-call reduction vs the "
                        f"oracle router "
                        f"{f4['strong_call_reduction_vs_oracle'] * 100:.2f}%"
                        f" / {rf4['strong_call_reduction_vs_oracle'] * 100:.2f}"
                        f"% / 50.2%; quality "
                        f"{f4['quality_vs_oracle'] * 100:.2f}% / "
                        f"{rf4['quality_vs_oracle'] * 100:.2f}% / 90.5%; "
                        f"aligned x{f4['aligned_vs_weak']:.2f} / "
                        f"x{rf4['aligned_vs_weak']:.2f} vs weak (paper "
                        f"+349%); x{f4['aligned_vs_cot']:.3f} / "
                        f"x{rf4['aligned_vs_cot']:.3f} vs CoT (paper +135%)")

        # G5: Table I from domain 0's recorded pool onto both domains
        want = record["table1"]
        t1_before = shapes.get(("memory_top1", 1, 1, 3), 0)
        t0 = time.perf_counter()
        got = table1(system, source, pools)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        t1_reads = shapes.get(("memory_top1", 1, 1, 3), 0) - t1_before
        n_reads = 2 * sum(len(p) for p in pools.values())
        t1_margin = (f"closest read to the {T1_THRESHOLD} threshold "
                     f"{got['threshold_margin']:.4f} away on the card, "
                     f"{want['threshold_margin']:.4f} in the record")
        bad = t1_faults(got, want, G_SIM_TOL)
        if bad:
            faults.append(f"G5 Table I differs: {bad[:4]}")
            log(f"G5 MISMATCH Table I: {bad}; {t1_margin}")
        else:
            log(f"G5 Table I card == JAX record (counts, percentages, "
                f"{n_reads} reads' rows, guided flags and weak answers; "
                f"sims within {G_SIM_TOL}); {t1_margin}; {dt:.1f} s on the "
                f"card (JAX on the CPU: {want['cpu_seconds']:.1f} s with "
                f"its reads twice)")
        for d, t in got["targets"].items():
            pct = [r["diff_from_strong_pct"] for r in got["rows"]
                   if r["target"] == t["target"]]
            log(f"G5 Table I {t['target']} (n={t['n']}), aligned inter / "
                f"intra / unguided: {t['inter']} / {t['intra']} / "
                f"{t['unguided']}; difference from the strong FM {pct}% "
                f"(paper: intra < inter <= unguided)")
        if t1_reads != n_reads:
            faults.append(f"G5 made {t1_reads} top-1 reads at B = 1, "
                          f"required = 3, not {n_reads}")
    finally:
        mt.memory_topk_batch_padded_cuda = topk_cuda
        mt.memory_top1_batch_padded_cuda = top1_cuda

    counts = ops.launch_counts()
    seconds = time.perf_counter() - t_phase
    log(f"G launches on the card: {counts}; store reads by (kernel, B, k, "
        f"required): {dict(sorted(shapes.items()))}; Phase G took "
        f"{seconds:.1f} s")
    for k in ("memory_topk", "memory_top1", "flash_attention",
              "decode_attention"):
        if counts[k] == 0:
            faults.append(f"G never launched {k}")
    if faults:
        raise AssertionError(f"Phase G: {faults}")
    return counts, dict(rates=rates, summary=summary, table1=got,
                        seconds=seconds)


# ---------------------------------------------------------------------------
# Phase A: the shadow plane's async and adaptive drains, the journal
# ---------------------------------------------------------------------------


def a_dir(tag: str) -> Path:
    """A fresh directory for a journal, under the gitignored build/."""
    import shutil
    path = ROOT / "build" / "phase_a" / tag
    shutil.rmtree(path, ignore_errors=True)
    path.mkdir(parents=True)
    return path


def same_engines(tag, a, b, what="stats"):
    for tier in ("weak", "strong"):
        x = getattr(getattr(a, tier).engine, what)()
        y = getattr(getattr(b, tier).engine, what)()
        if x != y:
            raise AssertionError(f"{tag} {tier} engine stats differ: {x} vs "
                                 f"{y}")


def same_run(tag, c, ref_ctrl, ref_outs):
    """A run of serve_rar equals a reference run field for field: Outcome
    streams, FM engine stats, store and RQ2 counters."""
    if [dataclasses.astuple(o) for o in c[1]] != ref_outs:
        raise AssertionError(f"{tag}: Outcome stream differs")
    same_engines(tag, c[0], ref_ctrl)
    same_store(c[0].memory, ref_ctrl.memory)
    for f in ("now", "guides_from_memory", "guides_generated"):
        if getattr(c[0], f) != getattr(ref_ctrl, f):
            raise AssertionError(f"{tag}: {f} differs")


def traced_runner(ctrl, seqs):
    """Wrap the queue's runner to record every drained item's seq."""
    orig = ctrl.shadow.runner

    def runner(items):
        orig(items)
        seqs.extend(it.seq for it in items)
    ctrl.shadow.runner = runner


def queue_invariants(tag, c, seqs):
    """tests/test_shadow.py::_stress's invariants after the last barrier."""
    ctrl, outs = c[0], c[1]
    q = ctrl.shadow
    if not (q.items_enqueued == q.items_drained == len(seqs)):
        raise AssertionError(f"{tag}: enqueued {q.items_enqueued}, drained "
                             f"{q.items_drained}, runner saw {len(seqs)}")
    if seqs != list(range(1, len(seqs) + 1)):
        raise AssertionError(f"{tag}: items did not drain once each in seq "
                             f"order")
    if any(o.case == "shadow_pending" for o in outs):
        raise AssertionError(f"{tag}: an Outcome is still shadow_pending")
    store = getattr(ctrl.memory, "store", ctrl.memory)
    if q.buffer.entries_applied != store.ptr:
        raise AssertionError(f"{tag}: entries_applied "
                             f"{q.buffer.entries_applied} != ptr {store.ptr}")
    if ctrl.memory_occupancy != store.size_fast:
        raise AssertionError(f"{tag}: occupancy {ctrl.memory_occupancy} != "
                             f"store size {store.size_fast}")


def die(ctrl):
    """What a crash leaves of a controller: its drainer stops with the
    failed epoch's items lost, its journal file closes."""
    q = ctrl.shadow
    with q._cv:
        q._items, q._stop = [], True
        q._cv.notify_all()
    if q._worker is not None:
        q._worker.join(WAIT_S)
        if q._worker.is_alive():
            raise AssertionError("a crashed controller's drainer is wedged")
    ctrl.commit_stream.journal.close()


def copy_store(st):
    from repro_torch.core import memory as mem
    return mem.MemoryState(emb=st.emb.clone(), mask=st.mask.clone(),
                           guide=st.guide.clone(), hard=st.hard.clone(),
                           added_at=st.added_at.clone(), ptr=st.ptr)


def phase_a(torch, ops, tiers, r_results):
    """A1-A3 (see the module docstring). Returns the launch counts, the
    results and the measured requests/s by mode."""
    import numpy as np

    from repro_torch.configs import rar_system
    from repro_torch.core import memory as mem
    from repro_torch.core.memory_ivf import IVFMemory
    from repro_torch.core.shadow import DrainPolicy
    from repro_torch.serving.faults import FaultPlan, InjectedFault

    cuda, cpu = torch.device(DEV), torch.device("cpu")
    vocab, prompts, greqs, embs = workload()
    mb, n = MICROBATCHES[0], PASSES * POOL
    ref = r_results[f"R1_mb{mb}"]
    results, rates = {}, {}
    ops.reset_launches()

    def serve(cfg, **kw):
        return serve_rar(cuda, tiers, None, mb, prompts, greqs, embs, vocab,
                         cfg=cfg, **kw)

    def always_drain(ctrl):
        pol = DrainPolicy()
        pol.register(ctrl.shadow)
        ctrl.shadow.drain_policy = pol

    # A1: deterministic schedules equal R1's inline run on the card
    serve_stream = torch.cuda.current_stream(cuda).cuda_stream
    for mode, flush, kw in (("async", 1, dict(flush_each=True)),
                            ("deferred", 1, {}),
                            ("adaptive", 0, dict(setup=always_drain))):
        cfg = rar_system.make_rar_config(shadow_mode=mode,
                                         shadow_flush_every=flush)
        before = ops.stream_launches()
        c = serve(cfg, **kw)
        c[0].close_shadow(timeout=WAIT_S)
        same_run(f"A1 {mode}", c, ref["ctrl"], ref["outcomes"])
        strong = sum(o.strong_calls for o in c[1])
        if strong != JAX_STRONG_CALLS:
            raise AssertionError(f"A1 {mode}: {strong} strong calls")
        line = (f"A1 {mode} (flush-every {flush}"
                f"{', barrier after every batch' if mode == 'async' else ''}"
                f"): Outcome streams, FM engine stats, store and counters == "
                f"R1 inline on the card; strong calls {strong} per {n}; "
                f"drains {c[0].shadow.drains}")
        if mode == "async":
            drainer = c[0].shadow.stream.cuda_stream
            after = ops.stream_launches()
            by = {}
            for (k, st), v in after.items():
                v -= before.get((k, st), 0)
                if v:
                    name = ("serve" if st == serve_stream else
                            "drainer" if st == drainer else f"stream {st}")
                    by.setdefault(k, {})[name] = v
            line += (f"; launches by stream (serve {serve_stream}, drainer "
                     f"{drainer}): {by}")
            for k in ("memory_topk", "flash_attention", "decode_attention"):
                if by.get(k, {}).get("drainer", 0) == 0:
                    raise AssertionError(f"A1 async: the drainer never "
                                         f"launched {k} on its stream")
            if set(by.get("memory_topk", {})) - {"serve", "drainer"}:
                raise AssertionError(f"A1 async: a launch on another stream"
                                     f": {by}")
            results["A1_streams"] = by
        log(line)

    # A2: unbarriered async and adaptive (inline and deferred beside
    # them, warm, in this call), journaled; invariants and the card store
    # against the journal replayed on the CPU
    for mode in ("inline", "deferred", "async", "adaptive"):
        path = a_dir(f"a2_{mode}")
        cfg = rar_system.make_rar_config(
            shadow_mode=mode,
            shadow_flush_every=1 if mode == "inline" else A2_FLUSH,
            journal_path=str(path), snapshot_every=A3_SNAPSHOT)
        seqs = []

        def setup(ctrl):
            traced_runner(ctrl, seqs)
            if mode == "async":
                ctrl.shadow.drain_delay = A2_DELAY
        c = serve(cfg, setup=setup)
        c[0].close_shadow(timeout=WAIT_S)
        queue_invariants(f"A2 {mode}", c, seqs)
        rec = mem.MemoryJournal.recover(str(path), cfg.memory, device=cpu)
        same_store(c[0].memory, rec[0])
        q = c[0].shadow
        if (rec[1], rec[2]) != (q.buffer.epoch, q.buffer.entries_applied):
            raise AssertionError(f"A2 {mode}: recovered epoch/entries "
                                 f"{rec[1:3]}")
        rates[mode if mode == "inline" else f"{mode}-{A2_FLUSH}"] = n / c[2]
        met = c[0].metrics()
        h = met["registry"]["shadow/drain_seconds"]
        line = (f"A2 {mode} flush-every {cfg.shadow_flush_every}"
                f"{f' drain_delay {A2_DELAY}s' if mode == 'async' else ''}: "
                f"invariants hold (items {q.items_enqueued} enqueued == "
                f"drained, once each in seq order, none pending, "
                f"entries_applied == ptr == {q.buffer.entries_applied}, "
                f"occupancy == store size); card store == the journal "
                f"replayed on the CPU (epoch {rec[1]}, "
                f"{c[0].commit_stream.journal.snapshots} snapshots); "
                f"strong calls {sum(o.strong_calls for o in c[1])}; "
                f"{q.drains} drains, drain seconds p50 {h['p50']:.6f} p99 "
                f"{h['p99']:.6f}; {n / c[2]:.1f} req/s")
        if mode == "adaptive":
            line += f"; policy {met['drain_policy']}"
        log(line)

    # A2b: the async leg on I1's IVF plane (no journal: as in JAX the IVF
    # plane cannot journal); the card store against its epochs' ops
    # replayed on a CPU IVF store
    clusters, probes = IVF_EXACT
    cfg = rar_system.make_rar_config(shadow_mode="async",
                                     shadow_flush_every=A2_FLUSH,
                                     retrieval_clusters=clusters,
                                     retrieval_probes=probes)
    seqs, epochs = [], []

    def setup_ivf(ctrl):
        traced_runner(ctrl, seqs)
        ctrl.shadow.drain_delay = A2_DELAY
        ctrl.commit_stream.ops_listener = \
            lambda e, r, s_, t, k: epochs.append((r, s_, t))
    before = ops.launch_counts()
    c = serve(cfg, setup=setup_ivf)
    c[0].close_shadow(timeout=WAIT_S)
    queue_invariants("A2b async IVF", c, seqs)
    host = IVFMemory(mem.init_memory(cfg.memory, device=cpu),
                     clusters=clusters, probes=probes)
    buf = mem.CommitBuffer()
    for r, s_, t in epochs:
        host, _ = buf.apply_ops(host, r, s_, t)
    same_store(c[0].memory.store, host.store)
    card = c[0].memory
    for f in ("_assign", "_members", "_cent"):
        if not np.array_equal(getattr(card, f), getattr(host, f)):
            raise AssertionError(f"A2b: IVF index {f} differs from the CPU "
                                 f"replay")
    got = {k: v - before[k] for k, v in ops.launch_counts().items()}
    for k in ("ivf_route", "ivf_scan"):
        if got[k] == 0:
            raise AssertionError(f"A2b never launched {k}")
    log(f"A2b async IVF {clusters} clusters / {probes} probes, flush-every "
        f"{A2_FLUSH}: invariants hold ({len(seqs)} items); card store and "
        f"IVF index == {len(epochs)} epochs replayed on a CPU IVF store; "
        f"strong calls {sum(o.strong_calls for o in c[1])}; launches {got}; "
        f"{n / c[2]:.1f} req/s")
    log("A2 requests/s (host clock, microbatch 8, R1 workload, journaled;"
        f" R1's first, cold inline run {ref['req_per_s']:.1f}): " +
        ", ".join(f"{k} {v:.1f}" for k, v in rates.items()))
    results["A2_req_per_s"] = rates

    # A3: crash recovery on the card (async, a barrier after every batch)
    base_cfg = dict(shadow_mode="async", shadow_flush_every=1,
                    snapshot_every=A3_SNAPSHOT)
    path = a_dir("a3_ref")
    snaps = {}

    def keep(ctrl):
        ctrl.commit_stream.ops_listener = \
            lambda e, *a: snaps.__setitem__(e, copy_store(ctrl.memory))
    never = serve(rar_system.make_rar_config(journal_path=str(path),
                                             **base_cfg), setup=keep,
                  flush_each=True)
    never[0].close_shadow(timeout=WAIT_S)
    for kind, at in A3_CRASH.items():
        path = a_dir(f"a3_{kind}")
        spec = (FaultPlan.wal_crash if kind == "wal" else
                FaultPlan.apply_crash)(at=at)
        cfg = rar_system.make_rar_config(journal_path=str(path), **base_cfg)
        crashed = []
        try:
            serve(cfg, flush_each=True, fault_plan=FaultPlan([spec]),
                  setup=crashed.append)
        except RuntimeError as e:
            if not isinstance(e.__cause__, InjectedFault):
                raise
        else:
            raise AssertionError(f"A3 {kind}: the injected crash never fired")
        die(crashed[0])
        landing = at - 1 if kind == "wal" else at
        stream, state, man = mem.open_journaled_stream(
            str(path), cfg.memory, snapshot_every=A3_SNAPSHOT, device=cuda)
        stream.journal.close()
        if stream.buffer.epoch != landing:
            raise AssertionError(f"A3 {kind}: recovered epoch "
                                 f"{stream.buffer.epoch}, want {landing}")
        same_store(state, snaps[landing])
        # the recovered controller serves the rest of the stream
        rest = serve(cfg, start=man["now"], flush_each=True)
        rest[0].close_shadow(timeout=WAIT_S)
        k = man["now"]
        if [dataclasses.astuple(o) for o in rest[1]] != \
                [dataclasses.astuple(o) for o in never[1][k:]]:
            raise AssertionError(f"A3 {kind}: resumed Outcomes differ from "
                                 f"the never-crashed run's")
        same_engines(f"A3 {kind}", rest[0], never[0], "export_counters")
        same_store(rest[0].memory, never[0].memory)
        for f in ("now", "guides_from_memory", "guides_generated"):
            if getattr(rest[0], f) != getattr(never[0], f):
                raise AssertionError(f"A3 {kind}: {f} differs")
        log(f"A3 {kind} crash at epoch {at}: reopened on the card at epoch "
            f"{landing} == the never-crashed store after epoch {landing}; "
            f"the recovered controller served requests {k}..{n - 1} to the "
            f"never-crashed Outcomes, engine stats, store and counters")

    counts = ops.launch_counts()
    log(f"A launches on the card (A1-A3): {counts}")
    for k in ("memory_topk", "flash_attention", "decode_attention",
              "ivf_route", "ivf_scan"):
        if counts[k] == 0:
            raise AssertionError(f"Phase A never launched {k}")
    return counts, results


def phase_a4(torch, ops, system):
    """A4: the launcher in-process on Phase S's system, run twice on one
    journal; the restart's controller starts from the first run's final
    store and manifest."""
    import json as _json

    from repro_torch.core import memory as mem
    from repro_torch.experiments import stages
    from repro_torch.launch import serve

    path, mjson = a_dir("a4"), ROOT / "build" / "phase_a" / "a4.json"
    args = ["--device", DEV, "--microbatch", "16", "--stages", "2",
            "--shadow-mode", "async", "--shadow-flush-every", "2",
            "--journal-path", str(path), "--metrics-json", str(mjson),
            "--log-every", "0"]
    started = []
    base = stages.MicrobatchRAR

    class Recorded(base):
        """Keeps the store and manifest it starts from, and every manifest
        its commit stream journals."""
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            started.append((copy_store(self.memory), self._manifest_state()))
            self.journaled, provider = [], self.commit_stream.state_provider

            def journal_manifest():
                man = provider()
                self.journaled.append(copy.deepcopy(man))
                return man
            self.commit_stream.state_provider = journal_manifest

    saved = (serve.build_system, stages.MicrobatchRAR)
    serve.build_system = lambda device: system
    stages.MicrobatchRAR = Recorded
    ops.reset_launches()
    try:
        t0 = time.perf_counter()
        first, rar1 = serve.main(args)
        t1 = time.perf_counter()
        man1 = rar1.journaled[-1]
        met = _json.loads(mjson.read_text())["registry"]
        second, rar2 = serve.main(args)
        t2 = time.perf_counter()
    finally:
        serve.build_system, stages.MicrobatchRAR = saved
    if met["shadow/items_enqueued"] != met["shadow/items_drained"]:
        raise AssertionError(f"A4: metrics JSON enqueued "
                             f"{met['shadow/items_enqueued']} != drained "
                             f"{met['shadow/items_drained']}")
    store0, man0 = started[1]
    same_store(store0, rar1.memory)
    if man0 != man1:
        raise AssertionError("A4: the restart's manifest differs from the "
                             "last one run 1 journaled")
    rec = mem.MemoryJournal.recover(str(path), rar2.cfg.memory,
                                    device=torch.device(DEV))
    same_store(rec[0], rar2.memory)
    counts = ops.launch_counts()
    log(f"A4 launcher (async, flush-every 2, microbatch 16, 2 stages, "
        f"journaled): run 1 strong calls {[r.strong_calls for r in first]}, "
        f"aligned {[r.aligned for r in first]} in {t1 - t0:.1f} s; metrics "
        f"JSON items enqueued == drained == {met['shadow/items_drained']}; "
        f"the restart's controller started from run 1's final store (ptr "
        f"{store0.ptr}) and the last manifest it journaled (now "
        f"{man0['now']}, run 1 ended at {rar1.now}); run 2 strong calls"
        f" {[r.strong_calls for r in second]} in {t2 - t1:.1f} s; its "
        f"journal recovers its final store; launches {counts}")
    for k in ("memory_topk", "flash_attention", "decode_attention"):
        if counts[k] == 0:
            raise AssertionError(f"A4 never launched {k}")
    return counts, dict(first=rows(first), second=rows(second))


# ---------------------------------------------------------------------------
# Phase F: the serving fabrics (thread replicas, process workers, the
# continuous batcher and open-loop load)
# ---------------------------------------------------------------------------


def f_stream(mb):
    """R1's request stream at microbatch ``mb``: (prompts, guide requests,
    keys, embeddings) a batch, PASSES passes over the pool."""
    _, prompts, greqs, embs = workload()
    out = []
    for pos in range(0, PASSES * POOL, mb):
        first = pos % POOL
        sl = slice(first, first + mb)
        out.append((prompts[sl], greqs[sl],
                    list(range(first, first + len(prompts[sl]))), embs[sl]))
    return out


def f_serve(torch, fab, batches, how):
    """Serve ``batches`` through a fabric: ``"sync"`` (``process_batch`` on
    this thread), ``"serial"`` (one ticket at a time) or ``"all"`` (every
    ticket submitted, then the barrier). Returns the Outcomes and the wall
    seconds, the last barrier and a device sync included."""
    t0 = time.perf_counter()
    outs, tickets = [], []
    for p, g, k, e in batches:
        if how == "sync":
            outs += fab.process_batch(p, g, keys=k, embs=e)
        elif how == "serial":
            outs += fab.submit(p, g, keys=k, embs=e).wait(timeout=WAIT_S)
        else:
            tickets.append(fab.submit(p, g, keys=k, embs=e))
    fab.flush_shadow(timeout=WAIT_S)
    for t in tickets:
        outs += t.wait(timeout=WAIT_S)
    torch.cuda.synchronize()
    return outs, time.perf_counter() - t0


def f_counters(fab, tier):
    """A tier's (calls, tokens processed) over a fabric: the learn
    replica's engine, plus what process workers shipped."""
    own = getattr(fab.learn, tier).engine.export_counters()
    remote = getattr(fab, "_remote_engine", {}).get(tier, {})
    return (own["calls"] + remote.get("calls", 0),
            own["tokens_processed"] + remote.get("tokens_processed", 0))


def f_same_r1(tag, fab, outs, ref):
    """A fabric's run equals R1's card run field for field: Outcome
    streams, FM calls and tokens, store, clock and RQ2 counters; 192
    strong calls."""
    if [dataclasses.astuple(o) for o in outs] != ref["outcomes"]:
        raise AssertionError(f"{tag}: Outcome stream differs from R1's")
    ctrl = ref["ctrl"]
    for tier in ("weak", "strong"):
        want = getattr(ctrl, tier).engine.export_counters()
        if f_counters(fab, tier) != (want["calls"],
                                     want["tokens_processed"]):
            raise AssertionError(f"{tag} {tier}: calls/tokens "
                                 f"{f_counters(fab, tier)} vs R1's {want}")
    same_store(fab.memory, ctrl.memory)
    for f in ("now", "guides_from_memory", "guides_generated"):
        if getattr(fab, f) != getattr(ctrl, f):
            raise AssertionError(f"{tag}: {f} {getattr(fab, f)} vs R1's "
                                 f"{getattr(ctrl, f)}")
    strong = sum(o.strong_calls for o in outs)
    if strong != JAX_STRONG_CALLS:
        raise AssertionError(f"{tag}: {strong} strong calls")


def f_invariants(tag, fab, outs):
    """tests/test_fabric.py's invariants of a concurrent run: one Outcome a
    request and none pending after the barrier, every committed entry
    once in the ring, every replica's view the learn replica's store."""
    if len(outs) != PASSES * POOL or \
            any(o.case == "shadow_pending" for o in outs):
        raise AssertionError(f"{tag}: {len(outs)} Outcomes, or one still "
                             f"pending")
    st = fab.commit_stream
    if not (fab.memory.ptr == st.buffer.entries_applied == st.commits):
        raise AssertionError(f"{tag}: ptr {fab.memory.ptr}, entries "
                             f"{st.buffer.entries_applied}, commits "
                             f"{st.commits}")
    if not all(r.memory is fab.learn.memory for r in fab.replicas):
        raise AssertionError(f"{tag}: a replica's view is not the store")
    s = fab.stats()
    if s["items_enqueued"] != s["items_drained"]:
        raise AssertionError(f"{tag}: {s['items_enqueued']} items enqueued,"
                             f" {s['items_drained']} drained")


def smi_busy(fn):
    """Run ``fn`` while ``nvidia-smi`` samples the card's utilization every
    100 ms; returns (fn's result, the mean utilization in percent, the
    number of samples), or None for the share without ``nvidia-smi``."""
    import shutil
    if shutil.which("nvidia-smi") is None:
        return fn(), None, 0
    poll = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=utilization.gpu",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        out = fn()
    finally:
        poll.terminate()
        text = poll.communicate(timeout=30)[0]
    vals = [float(x) for x in text.split() if x.strip().isdigit()]
    return out, (sum(vals) / len(vals) if vals else None), len(vals)


def f_rates(runs):
    """Median and spread of the requests/s of ``runs`` (seconds each)."""
    rates = sorted(PASSES * POOL / s for s in runs)
    return dict(median=rates[len(rates) // 2], min=rates[0], max=rates[-1],
                runs=rates)


def phase_f(torch, ops, tiers, r_results):
    """F1-F4 (see the module docstring). Returns the launch counts (the
    parent's and every worker's) and the measured rates."""
    import functools

    from repro_torch.configs import rar_system
    from repro_torch.core.fm import FMTier
    from repro_torch.experiments import stages
    from repro_torch.serving.fabric import ServingFabric
    from repro_torch.serving.faults import FaultPlan
    from repro_torch.serving.loadgen import poisson_trace
    from repro_torch.serving.procfabric import ProcessServingFabric
    from repro_torch.serving.scheduler import serve_trace

    cuda, cpu = torch.device(DEV), torch.device("cpu")
    vocab, prompts, greqs, embs = workload()
    results, worker_counts = {}, {}
    ref = r_results[f"R1_mb{MICROBATCHES[0]}"]
    batches = f_stream(MICROBATCHES[0])

    def tiers_on(dev):
        return (FMTier.create("weak", rar_system.WEAK,
                              to_device(tiers[0], dev), vocab),
                FMTier.create("strong", rar_system.STRONG,
                              to_device(tiers[1], dev), vocab))

    def thread_fab(n, dev=cuda, **cfg):
        weak, strong = tiers_on(dev)
        return ServingFabric(weak, strong, None, lambda e, k: False,
                             rar_system.make_rar_config(**cfg), replicas=n,
                             device=dev)

    weak, strong = tiers_on(cuda)
    factory = functools.partial(stages._proc_replica_parts,
                                stages._tier_spec(weak),
                                stages._tier_spec(strong), frozenset())

    def proc_fab(n, **kw):
        cfg = rar_system.make_rar_config(**kw.pop("cfg", {}))
        return ProcessServingFabric(factory, cfg, workers=n, device=cuda,
                                    **kw)

    def ready(*fabs):
        for fab in fabs:
            for h in fab._handles:
                if not h.ready.wait(WAIT_S):
                    raise AssertionError("F3: a worker never became ready")

    def close_procs(*fabs):
        """Count the workers' launches, then close the fabrics together
        (each close joins its workers' exits), raising the first error."""
        import threading
        for fab in fabs:
            for k, v in fab.worker_launches().items():
                worker_counts[k] = worker_counts.get(k, 0) + v
        errors = []

        def close(fab):
            try:
                fab.close_shadow()
            except BaseException as e:      # raised below, on this thread
                errors.append(e)
        threads = [threading.Thread(target=close, args=(f,)) for f in fabs]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]

    t_phase = time.perf_counter()
    ops.reset_launches()
    # F1: the 1-replica fabric, synchronous, equals R1 (microbatch 8, 32)
    for mb in MICROBATCHES:
        fab = thread_fab(1)
        outs, _ = f_serve(torch, fab, f_stream(mb), "sync")
        f_same_r1(f"F1 mb={mb}", fab, outs, r_results[f"R1_mb{mb}"])
        fab.close_shadow()
    log(f"F1 ServingFabric(replicas=1), process_batch at microbatch "
        f"{MICROBATCHES}: Outcome streams, FM calls and tokens, store, "
        f"clock and counters == R1's card run; {JAX_STRONG_CALLS} strong "
        f"calls per {PASSES * POOL}")

    # F2: thread replicas; serialized == R1, concurrent keeps invariants,
    # and async at flush-every F_ASYNC_FLUSH (a drainer stream a replica)
    for n in F_REPLICAS[1:]:
        fab = thread_fab(n)
        outs, _ = f_serve(torch, fab, batches, "serial")
        f_same_r1(f"F2 {n} replicas serialized", fab, outs, ref)
        fab.close_shadow()
        for mode in ("inline", "async"):
            before = ops.stream_launches()
            fab = thread_fab(n, shadow_mode=mode,
                             shadow_flush_every=1 if mode == "inline"
                             else F_ASYNC_FLUSH)
            outs, dt = f_serve(torch, fab, batches, "all")
            fab.close_shadow()
            f_invariants(f"F2 {n} replicas {mode}", fab, outs)
            streams = {st for (k, st), v in ops.stream_launches().items()
                       if k == "memory_topk" and v > before.get((k, st), 0)}
            log(f"F2 {n} replicas, {mode}"
                f"{f' flush-every {F_ASYNC_FLUSH}' if mode == 'async' else ''}"
                f", every ticket submitted then joined: invariants hold "
                f"(one Outcome a request, ptr == entries_applied == commits"
                f" == {fab.memory.ptr}, one store in every view); strong "
                f"calls {sum(o.strong_calls for o in outs)}; memory_topk on "
                f"{len(streams)} CUDA streams; {PASSES * POOL / dt:.1f} "
                f"req/s")
            if mode == "async" and len(streams) < 2:
                raise AssertionError(f"F2 {n} replicas async: the store read"
                                     f" ran on {len(streams)} stream(s)")

    # rates: closed loop, every ticket submitted then joined, inline;
    # 3 runs a configuration, thread replicas and process workers
    rates = {}
    for n in F_REPLICAS:
        def runs():
            secs = []
            for _ in range(F_RUNS):
                fab = thread_fab(n)
                outs, dt = f_serve(torch, fab, batches, "all")
                fab.close_shadow()
                f_invariants(f"rates thread {n}", fab, outs)
                secs.append(dt)
            return secs
        secs, busy, samples = smi_busy(runs)
        rates[f"thread-{n}"] = dict(f_rates(secs), busy=busy,
                                    samples=samples)
    spent = {}
    for n in F_REPLICAS:
        t0 = time.perf_counter()
        fabs = [proc_fab(n) for _ in range(F_RUNS)]
        ready(*fabs)                           # spawn time not counted
        t1 = time.perf_counter()

        def runs():
            secs = []
            for i, fab in enumerate(fabs):
                outs, dt = f_serve(torch, fab, batches, "all")
                if n == 1:
                    # F3: one worker, pipelined submission, equals R1
                    f_same_r1(f"F3 1 worker pipelined (run {i + 1})", fab,
                              outs, ref)
                else:
                    f_invariants(f"rates process {n}", fab, outs)
                secs.append(dt)
            return secs
        secs, busy, samples = smi_busy(runs)
        t2 = time.perf_counter()
        close_procs(*fabs)
        spent[n] = (t1 - t0, t2 - t1, time.perf_counter() - t2)
        rates[f"process-{n}"] = dict(f_rates(secs), busy=busy,
                                     samples=samples)
    log(f"F3 1 worker, every ticket submitted at once (the ack gate), "
        f"{F_RUNS} fabrics: each == R1's card run. Process fabrics, seconds"
        f" to spawn until every worker is ready / to serve the runs / to "
        f"close: " + "; ".join(f"{n} worker(s) {a:.1f} / {b:.1f} / {c:.1f}"
                               for n, (a, b, c) in spent.items()))
    for k, v in rates.items():
        busy = ("not measured" if v["busy"] is None else
                f"{v['busy']:.1f}% ({v['samples']} samples)")
        log(f"F rates {k}: {v['median']:.1f} req/s median of {F_RUNS} "
            f"({v['min']:.1f}-{v['max']:.1f}; closed loop, microbatch "
            f"{MICROBATCHES[0]}, R1's workload, spawn excluded); card busy "
            f"(nvidia-smi utilization.gpu, 100 ms samples) {busy}")
    results["rates"] = rates

    # F3: two workers serialized; a SIGKILL of worker 1; a whole-fabric
    # kill and a rebuild on the same journal. Started after the rate
    # fabrics are closed: an idle worker starved of the host's cores while
    # a dozen others start can miss its lease and be replaced
    f3 = (proc_fab(2), proc_fab(2, fault_plan=FaultPlan(
        [FaultPlan.replica_kill(1, at=2)])))
    ready(*f3)
    fab = f3[0]
    outs, _ = f_serve(torch, fab, batches, "serial")
    f_same_r1("F3 2 workers serialized", fab, outs, ref)
    fab = f3[1]
    outs, _ = f_serve(torch, fab, batches, "serial")
    f_same_r1("F3 2 workers, worker 1 SIGKILLed", fab, outs, ref)
    if not (fab.deaths == fab.restarts == fab.redispatches == 1):
        raise AssertionError(f"F3 kill: deaths {fab.deaths}, restarts "
                             f"{fab.restarts}, redispatches "
                             f"{fab.redispatches}")
    close_procs(*f3)
    path = a_dir("f3_journal")
    jcfg = dict(journal_path=str(path), snapshot_every=A3_SNAPSHOT)
    half = len(batches) // 2
    fab = proc_fab(1, cfg=jcfg)
    outs, _ = f_serve(torch, fab, batches[:half], "serial")
    for k, v in fab.worker_launches().items():
        worker_counts[k] = worker_counts.get(k, 0) + v
    fab.kill()
    fab = proc_fab(1, cfg=jcfg)
    more, _ = f_serve(torch, fab, batches[half:], "serial")
    f_same_r1("F3 whole-fabric kill, rebuilt on its journal", fab,
              outs + more, ref)
    close_procs(fab)
    log(f"F3 ProcessServingFabric on the card (spawn): 2 workers "
        f"serialized == R1; worker 1 SIGKILLed at its 2nd batch: deaths == "
        f"restarts == redispatches == 1, == R1; killed after {half} batches"
        f" and rebuilt on its journal: served on to R1's Outcomes, store "
        f"and counters; the workers' launches {worker_counts} (the serve "
        f"plane decodes nothing: answers take one token; guides, the "
        f"decode steps, are generated in the parent's drains)")
    if cuda.type == "cuda":
        for k in ("memory_topk", "flash_attention"):
            if worker_counts.get(k, 0) == 0:
                raise AssertionError(f"F3: no worker launched {k}")

    # F4: open loop through the continuous batcher
    def open_loop(fab, rate, pace=False, replicas=1):
        trace = poisson_trace([PASSES * POOL // 2] * 2, rate, seed=F4_SEED,
                              streams=2)
        order = [[p for p in range(PASSES * POOL) if p % 2 == j]
                 for j in range(2)]
        cursors = [0, 0]

        def make_request(ev):
            pos = order[ev.stream][cursors[ev.stream]]
            cursors[ev.stream] += 1
            i = pos % POOL
            return prompts[i], greqs[i], i, embs[i]
        t0 = time.perf_counter()
        outs, bat = serve_trace(fab, trace, make_request,
                                microbatch=MICROBATCHES[0], slo_ms=F4_SLO_MS,
                                replica_fn=lambda s: s % replicas,
                                pace=pace, timeout=WAIT_S)
        fab.flush_shadow(timeout=WAIT_S)
        dt = time.perf_counter() - t0
        fab.close_shadow()
        return outs, bat, dt

    runs = []
    for dev in (cuda, cuda, cpu):
        outs, bat, _ = open_loop(thread_fab(1, dev), F4_RATE)
        runs.append(([dataclasses.astuple(o) for o in outs],
                     [[r.index for r in d.requests] for d in bat.dispatches],
                     dict(bat.closes)))
    if runs[0] != runs[1]:
        raise AssertionError("F4: two card runs of one trace differ")
    if runs[0][0] != runs[2][0]:
        raise AssertionError("F4: card and CPU Outcomes differ")
    log(f"F4 open loop, poisson trace of {PASSES * POOL} requests on 2 "
        f"streams at {F4_RATE:g} req/s (seed {F4_SEED}, slo {F4_SLO_MS} ms,"
        f" virtual time) over a 1-replica fabric: two card runs give the "
        f"same {len(runs[0][1])} batches (closes {runs[0][2]}) and Outcomes,"
        f" the CPU the same Outcomes; strong calls "
        f"{sum(o[2] for o in runs[0][0])}")
    closed = rates[f"thread-{F_REPLICAS[1]}"]["median"]
    for load in F4_LOADS:
        fab = thread_fab(F_REPLICAS[1])
        outs, bat, dt = open_loop(fab, load * closed, pace=True,
                                  replicas=F_REPLICAS[1])
        reg = fab.metrics_registry.snapshot()
        qd, e2e = reg["sched/queue_delay_ms"], reg["sched/e2e_ms"]
        if qd["count"] != PASSES * POOL or len(outs) != PASSES * POOL:
            raise AssertionError(f"F4 paced: {qd['count']} delays, "
                                 f"{len(outs)} Outcomes")
        results[f"F4_{load}"] = dict(rate=load * closed, qd_p50=qd["p50"],
                                     qd_p99=qd["p99"], e2e_p99=e2e["p99"],
                                     wall=dt)
        log(f"F4 paced, {F_REPLICAS[1]} replicas at {load:.0%} of the "
            f"closed-loop {closed:.1f} req/s ({load * closed:.1f} req/s): "
            f"queue delay p50 {qd['p50']:.3f} ms, p99 {qd['p99']:.3f} ms; "
            f"end to end p99 {e2e['p99']:.3f} ms; {bat.stats()['batches']}"
            f" batches (closes {bat.closes}); wall {dt:.3f} s")

    counts = ops.launch_counts()
    log(f"F launches on the card: the parent's {counts}, the workers' "
        f"{worker_counts}; Phase F took "
        f"{time.perf_counter() - t_phase:.1f} s")
    for k, v in worker_counts.items():
        counts[k] = counts.get(k, 0) + v
    for k in ("memory_topk", "flash_attention", "decode_attention"):
        if counts.get(k, 0) == 0:
            raise AssertionError(f"Phase F never launched {k}")
    return counts, results


def phase_f5(torch, ops, system):
    """F5: the launcher on Phase S's system with two worker processes and
    open-loop poisson arrivals: every request answered once a stage, the
    metrics JSON with the scheduler's and the replicas' entries."""
    import json as _json

    from repro_torch.launch import serve
    from repro_torch.serving.procfabric import ProcessServingFabric

    mjson = ROOT / "build" / "phase_f" / "f5.json"
    mjson.parent.mkdir(parents=True, exist_ok=True)
    n, n_stages = F5_REQUESTS, 2
    args = ["--device", DEV, "--requests", str(n), "--stages", str(n_stages),
            "--microbatch", str(MICROBATCHES[0]), "--replicas", "2",
            "--transport", "process", "--arrival-pattern", "poisson",
            "--arrival-rate", str(F4_RATE), "--metrics-json", str(mjson),
            "--log-every", "0"]
    tickets = []
    base = ProcessServingFabric.submit

    def submit(self, *a, **kw):
        t = base(self, *a, **kw)
        tickets.append(t)
        return t
    saved = serve.build_system
    serve.build_system = lambda device: system
    ProcessServingFabric.submit = submit
    ops.reset_launches()
    try:
        t0 = time.perf_counter()
        results, rar = serve.main(args)
        dt = time.perf_counter() - t0
    finally:
        serve.build_system = saved
        ProcessServingFabric.submit = base
    counts = ops.launch_counts()
    outs = [o for t in tickets for o in t.wait(timeout=WAIT_S)]
    met = _json.loads(mjson.read_text())
    reg = met["registry"]
    if [r.n for r in results] != [n] * n_stages or \
            len(outs) != n * n_stages or \
            sum(r.strong_calls for r in results) != \
            sum(o.strong_calls for o in outs):
        raise AssertionError(f"F5: stages {[r.n for r in results]}, "
                             f"{len(outs)} Outcomes")
    if reg.get("sched/admitted") != n * n_stages or \
            reg["sched/queue_delay_ms"]["count"] != n * n_stages or \
            len(met["workers"]) != 2 or \
            "replica0/shadow/items_drained" not in reg:
        raise AssertionError(f"F5: metrics JSON lacks the scheduler's or "
                             f"the replicas' entries: {sorted(reg)[:12]}")
    if rar.commit_stream.buffer.entries_applied != rar.memory.ptr:
        raise AssertionError("F5: entries_applied != ptr")
    workers = rar.worker_launches()
    log(f"F5 launcher --replicas 2 --transport process --arrival-pattern "
        f"poisson on Phase S's system ({n} questions, {n_stages} stages, "
        f"microbatch {MICROBATCHES[0]}): every request answered once a "
        f"stage, strong calls {[r.strong_calls for r in results]}, aligned "
        f"{[r.aligned for r in results]}; metrics JSON: sched/admitted "
        f"{reg['sched/admitted']}, queue delay p50 "
        f"{reg['sched/queue_delay_ms']['p50']:.3f} ms, p99 "
        f"{reg['sched/queue_delay_ms']['p99']:.3f} ms, workers "
        f"{[w['alive'] for w in met['workers']]}; {dt:.1f} s with spawn; "
        f"launches: the parent's {counts}, the workers' {workers}")
    for k, v in workers.items():
        counts[k] = counts.get(k, 0) + v
    for k in ("memory_topk", "flash_attention", "decode_attention"):
        if counts.get(k, 0) == 0:
            raise AssertionError(f"F5 never launched {k}")
    return counts, dict(strong=rows(results))


# ---------------------------------------------------------------------------
# Phase M: the sharded guide store, logical shards on the one card
# ---------------------------------------------------------------------------


def same_reads(tag, a, b):
    """Two lists of store reads equal bit for bit: the sims' bits and the
    packed meta."""
    import numpy as np
    for i, (x, y) in enumerate(zip(a, b, strict=True)):
        x, y = x.device_get(), y.device_get()
        if not (np.array_equal(np.atleast_1d(x.sim).view(np.int32),
                               np.atleast_1d(y.sim).view(np.int32))
                and np.array_equal(x.meta, y.meta)):
            raise AssertionError(f"{tag}: read {i} differs")


def store_reads(store, qs, ks=(1, 4), top1=True):
    """Every exact read of a store in both views: ``query`` (qs[0]) and
    ``query_batch`` (unless not ``top1``), and ``query_topk``/
    ``query_topk_batch`` at each k."""
    from repro_torch.core import memory as mem
    out = []
    for g in (False, True):
        if top1:
            out += [mem.query(store, qs[0], guides_only=g),
                    mem.query_batch(store, qs, guides_only=g)]
        for k in ks:
            out += [mem.query_topk(store, qs[0], k, guides_only=g),
                    mem.query_topk_batch(store, qs, k, guides_only=g)]
    return out


def plain_topk_reads(store, qs, k):
    """``store_reads(store, qs, (k,), top1=False)`` computed by the top-k
    kernel's plain version on the store's device: the reference where the
    kernel refuses the store."""
    from repro_torch.core import memory as mem
    from repro_torch.kernels import memory_topk as mt
    out = []
    for g in (False, True):
        req = mem.required_bits(g)
        for sim, idx in (
                mt.memory_topk_padded_plain(store.emb, qs[0], store.mask, k,
                                            req),
                mt.memory_topk_batch_padded_plain(store.emb, qs, store.mask,
                                                  k, req)):
            out.append(mem.TopKResult(sim=sim, meta=mem.pack_meta(store,
                                                                  idx)))
    return out


def m2_commits(torch, C, G, dev):
    """M2's commits, made on ``dev`` from a seeded generator: C unit rows
    of 384 lanes in commits of M2_COMMIT, half with a guide; slot C - 7
    repeats slot 5, a tie across shards."""
    gen = torch.Generator(device=dev)
    first = None
    for i in range(0, C, M2_COMMIT):
        n = min(M2_COMMIT, C - i)
        gen.manual_seed(SEEDS["store"] * 100_003 + i)
        x = torch.randn((n, 384), generator=gen, device=dev)
        x /= x.norm(dim=1, keepdim=True)
        if first is None:
            first = x[5].clone()
        if i + n == C:
            x[n - 7] = first
        yield (x, torch.zeros((n, G), dtype=torch.int32, device=dev),
               torch.rand(n, generator=gen, device=dev) < 0.5,
               torch.zeros(n, dtype=torch.bool, device=dev),
               torch.arange(i, i + n, dtype=torch.int32, device=dev))


def phase_m(torch, ops, tiers, r_results, i_results):
    """M1-M4 (see the module docstring). Returns the launch counts of the
    phase's main path (the timed reads' launches taken out) and the
    measured times."""
    import numpy as np

    from repro_torch.configs import rar_system
    from repro_torch.core import memory as mem
    from repro_torch.core.fm import FMTier
    from repro_torch.core.memory_sharded import ShardedMemory
    from repro_torch.serving.fabric import ServingFabric

    cuda = torch.device(DEV)
    vocab, prompts, greqs, embs = workload()
    mb, n = MICROBATCHES[0], PASSES * POOL
    ref = r_results[f"R1_mb{mb}"]
    results, timing = {}, {}
    t_phase = time.perf_counter()
    ops.reset_launches()

    def timed(fn, tag):
        """CUDA-event and device time of one call of ``fn``; its launches
        are measurements, kept out of the phase's counts."""
        before = ops.launch_counts()
        out = (time_ms(torch, fn), device_ms(torch, fn, tag)[0])
        for k, v in ops.launch_counts().items():
            timing[k] = timing.get(k, 0) + v - before[k]
        return out

    def show(ms):
        return "not measured" if ms is None else f"{ms:.4f}"

    # M1: R1 on 2 and 4 shards equals R1; async at flush-every 4 on 4
    cfg = rar_system.make_rar_config()
    C = cfg.memory.capacity
    c = serve_rar(cuda, tiers, None, mb, prompts, greqs, embs, vocab)
    log(f"M1 R1 again on the single-device store (warm): {n / c[2]:.1f} "
        f"req/s")
    for S in M1_SHARDS:
        store = ShardedMemory(cfg.memory, shards=S, device=cuda)
        c = serve_rar(cuda, tiers, None, mb, prompts, greqs, embs, vocab,
                      memory=store)
        if c[0].memory is not store:
            raise AssertionError(f"M1 S={S}: the controller left the store")
        same_run(f"M1 S={S}", c, ref["ctrl"], ref["outcomes"])
        strong = sum(o.strong_calls for o in c[1])
        if strong != JAX_STRONG_CALLS:
            raise AssertionError(f"M1 S={S}: {strong} strong calls")
        log(f"M1 {S} shards of {C // S} rows: Outcome streams, FM engine "
            f"stats, store (to_single_device) and counters == R1's card run"
            f"; strong calls {strong} per {n}; {n / c[2]:.1f} req/s")
    S = M1_SHARDS[-1]
    store = ShardedMemory(cfg.memory, shards=S, device=cuda)
    seqs = []

    def setup(ctrl):
        traced_runner(ctrl, seqs)
        ctrl.shadow.drain_delay = A2_DELAY
    before = ops.stream_launches()
    acfg = rar_system.make_rar_config(shadow_mode="async",
                                      shadow_flush_every=A2_FLUSH)
    c = serve_rar(cuda, tiers, None, mb, prompts, greqs, embs, vocab,
                  cfg=acfg, memory=store, setup=setup)
    c[0].close_shadow(timeout=WAIT_S)
    queue_invariants(f"M1 async S={S}", c, seqs)
    single = store.to_single_device()
    valid = int(single.valid.sum())
    if valid != min(store.ptr, C):
        raise AssertionError(f"M1 async: {valid} valid rows, ptr "
                             f"{store.ptr}")
    qs = torch.from_numpy(embs).to(cuda)
    same_reads("M1 async: sharded against to_single_device",
               store_reads(store, qs), store_reads(single, qs))
    streams = {st for (k, st), v in ops.stream_launches().items()
               if k == "memory_topk" and v > before.get((k, st), 0)}
    if len(streams) < 2:
        raise AssertionError(f"M1 async: the store read ran on "
                             f"{len(streams)} CUDA stream(s)")
    log(f"M1 async flush-every {A2_FLUSH} drain_delay {A2_DELAY}s on {S} "
        f"shards: invariants hold ({len(seqs)} items drained once each in "
        f"seq order, none pending, entries_applied == ptr == {store.ptr}); "
        f"to_single_device holds {valid} valid rows == min(ptr, C); every "
        f"read (query, query_batch B={len(qs)}, top-k k=1/4, both views) "
        f"== the same read of to_single_device bit for bit; memory_topk on "
        f"{len(streams)} CUDA streams; strong calls "
        f"{sum(o.strong_calls for o in c[1])}; {n / c[2]:.1f} req/s")
    del store, single, c

    # M2: the exact reads at E = 384 over growing stores, each S beside
    # the single-device store that took the same commits
    G = cfg.memory.guide_len
    for C in M2_CAPACITIES:
        mcfg = mem.MemoryConfig(capacity=C, embed_dim=384, guide_len=G)
        single = mem.init_memory(mcfg, device=cuda)
        for commit in m2_commits(torch, C, G, cuda):
            mem.add_batch(single, *commit)
        gen = torch.Generator(device=cuda)
        gen.manual_seed(SEEDS["store"] + C)
        qs = torch.randn((M2_B, 384), generator=gen, device=cuda)
        qs /= qs.norm(dim=1, keepdim=True)
        qs[0] = single.emb[5, :384]          # a row stored twice
        want = store_reads(single, qs, ks=(1,))
        want4 = store_reads(single, qs, ks=(4,), top1=False)
        line = []
        if C != M2_CAPACITIES[0]:
            # Z4: the single-device top-4 reads (B = 1 and 32, both views)
            # past the list mode's old ~385K-row limit, bit for bit its
            # plain version run on the card
            same_reads(f"Z4 C={C}: top-4 kernel against its plain version",
                       want4, plain_topk_reads(single, qs, 4))
            z4 = {B: timed(lambda B=B: mem.query_topk_batch(single, qs[:B], 4),
                           f"z4_{C}_B{B}") for B in (1, M2_B)}
            log(f"Z4 C={C} x 384, one store: query_topk (B=1) and "
                f"query_topk_batch (B={M2_B}) at k=4, both views, == the "
                f"kernel's plain version on the card bit for bit; ms a read, "
                f"CUDA events (device): "
                + "; ".join(f"B={B} {show(t[0])} ({show(t[1])})"
                            for B, t in z4.items()))
            results[f"Z4_C{C}"] = {f"B{B}": dict(ms=t[0], device_ms=t[1])
                                   for B, t in z4.items()}
            line.append("single-device top-4 == its plain version (Z4)")
        if C == M2_CAPACITIES[0]:
            host = mem.init_memory(mcfg, device="cpu")
            for commit in m2_commits(torch, C, G, cuda):
                mem.add_batch(host, *(t.cpu() for t in commit))
            same_reads(f"M2 C={C}: card against the CPU's plain reads",
                       want + want4, store_reads(host, qs.cpu(), ks=(1,))
                       + store_reads(host, qs.cpu(), ks=(4,), top1=False))
            line.append("single-device card == CPU plain")
            del host
        Ep = single.emb.shape[1]
        b = (C * Ep * 4 + C * 4 + qs.numel() * 4) / HBM_BYTES_PER_S * 1e3
        rows = {"single": (timed(lambda: mem.query_batch(single, qs),
                                 f"m2_{C}_single_top1"),
                           timed(lambda: mem.query_topk_batch(single, qs, 4),
                                 f"m2_{C}_single_top4"))}
        for S in M2_SHARDS:
            sh = ShardedMemory(mcfg, shards=S, device=cuda)
            for commit in m2_commits(torch, C, G, cuda):
                mem.add_batch(sh, *commit)
            same_reads(f"M2 C={C} S={S}", store_reads(sh, qs, ks=(1,)),
                       want)
            same_reads(f"M2 C={C} S={S} k=4",
                       store_reads(sh, qs, ks=(4,), top1=False), want4)
            rows[f"S={S}"] = (
                timed(lambda: mem.query_batch(sh, qs), f"m2_{C}_s{S}_top1"),
                timed(lambda: mem.query_topk_batch(sh, qs, 4),
                      f"m2_{C}_s{S}_top4"))
            del sh
            torch.cuda.empty_cache()
        del single
        torch.cuda.empty_cache()
        timing_line = "; ".join(
            f"{k}: top-1 {show(t1[0])} ({show(t1[1])}), top-4 "
            f"{show(t4[0])} ({show(t4[1])})" for k, (t1, t4) in rows.items())
        log(f"M2 C={C} x 384 (commits of {M2_COMMIT}), S in {M2_SHARDS}: "
            f"every read (query, query_batch B={M2_B}, top-k k=1 and 4, both "
            f"views) == the single-device store's bit for bit"
            f"{'; ' + ', '.join(line) if line else ''}. ms a read, CUDA "
            f"events (device): {timing_line}; bound {b:.4f} ms (the rows "
            f"and mask at 3.35 TB/s)")
        results[f"M2_C{C}"] = dict(bound_ms=b, **{
            k: dict(top1_ms=t1[0], top1_device_ms=t1[1], top4_ms=t4[0],
                    top4_device_ms=t4[1])
            for k, (t1, t4) in rows.items()})

    # M3: I2's setting on a 4-shard backing, over the same commits as I2
    C, clusters, probes = IVF_STORE
    icfg, full_store, rng, protos, rows_ = i2_store(torch)
    src = full_store(cuda)
    sh = ShardedMemory(icfg.memory, shards=M3_SHARDS, device=cuda)
    mem.add_batch(sh, src.emb[:C, :384], src.guide, src.has_guide, src.hard,
                  src.added_at)
    del src
    mb3 = MICROBATCHES[-1]
    i2 = i_results[f"I2_mb{mb3}"]
    served = i_results["I2_served"]
    c = serve_rar(cuda, tiers, None, mb3, prompts, greqs, embs, vocab,
                  cfg=icfg, memory=sh)
    ivf = c[0].memory
    if ivf.store is not sh:
        raise AssertionError("M3: the IVF plane is not over the sharded store")
    if [dataclasses.astuple(o) for o in c[1]] != i2["outcomes"]:
        raise AssertionError("M3: Outcome stream differs from I2's")
    same_engines("M3", c[0], i2["ctrl"])
    same_store(sh, served["card"].store)
    for f in ("_assign", "_members", "_cent", "_ccount"):
        if not np.array_equal(getattr(ivf, f), getattr(served["card"], f)):
            raise AssertionError(f"M3: IVF index {f} differs from I2's")
    qs = near(rng, protos, 32)
    qs[0] = rows_[C - 1]
    qs[1] = embs[0]

    def ivf_reads(plane):
        return [plane.query_topk_batch(qs, 4)] + [
            plane.query_topk(q, 4) for q in qs[:4]]
    got = ivf_reads(ivf)
    same_reads("M3: against I2's card IVF reads", got,
               ivf_reads(served["card"]))
    same_reads("M3: against I2's CPU IVF reads", got, ivf_reads(served["cpu"]))
    qr = near(rng, protos, 256)
    top = ivf.query_topk_batch(qr, 4).device_get().index
    exact = ivf.exact_query_topk_batch(qr, 4).device_get().index
    recall = float(np.mean([len(set(top[i]) & set(exact[i])) / 4
                            for i in range(len(qr))]))
    if recall != i_results["I2_ivf"]["recall_at_4"]:
        raise AssertionError(f"M3: recall@4 {recall} against I2's "
                             f"{i_results['I2_ivf']['recall_at_4']}")
    q32 = torch.from_numpy(qr[:32]).to(cuda)
    t_sh = timed(lambda: ivf.query_topk_batch(q32, 4), "m3_sharded_read")
    t_i2 = timed(lambda: served["card"].query_topk_batch(q32, 4), "m3_i2_read")
    log(f"M3 I2 on {M3_SHARDS} shards ({clusters} clusters, {probes} "
        f"probes, the route merged from {M3_SHARDS} planes of "
        f"{clusters // M3_SHARDS}): I2's Outcome stream at microbatch {mb3} "
        f"(strong calls {sum(o.strong_calls for o in c[1])}), engine stats, "
        f"store and IVF index == I2's; query_topk_batch B=32 k=4 and 4 "
        f"single reads == I2's card and CPU reads bit for bit; recall@4 "
        f"{recall:.4f} == I2's; read B=32 k=4, ms (device ms): sharded "
        f"{show(t_sh[0])} ({show(t_sh[1])}), I2 {show(t_i2[0])} "
        f"({show(t_i2[1])})")
    results["M3"] = dict(recall_at_4=recall, sharded_ms=t_sh[0],
                         sharded_device_ms=t_sh[1], i2_ms=t_i2[0],
                         i2_device_ms=t_i2[1])
    del sh, ivf, c

    # M4: two thread replicas, serialized, over one 4-shard store
    weak = FMTier.create("weak", rar_system.WEAK, to_device(tiers[0], cuda),
                         vocab)
    strong = FMTier.create("strong", rar_system.STRONG,
                           to_device(tiers[1], cuda), vocab)
    store = ShardedMemory(cfg.memory, shards=4, device=cuda)
    fab = ServingFabric(weak, strong, None, lambda e, k: False, cfg,
                        replicas=2, memory=store, device=cuda)
    outs, _ = f_serve(torch, fab, f_stream(mb), "serial")
    if not all(r.memory is store for r in fab.replicas):
        raise AssertionError("M4: a replica's view is not the one store")
    f_same_r1("M4 2 replicas serialized on 4 shards", fab, outs, ref)
    fab.close_shadow()
    log(f"M4 ServingFabric(replicas=2) over one 4-shard store, one ticket at "
        f"a time: Outcome streams, FM calls and tokens, store, clock and "
        f"counters == R1's card run; {JAX_STRONG_CALLS} strong calls")
    del fab, store
    torch.cuda.empty_cache()

    counts = {k: v - timing.get(k, 0) for k, v in ops.launch_counts().items()}
    log(f"M launches on the card (main path; the timed reads' {timing} "
        f"taken out): {counts}; Phase M took "
        f"{time.perf_counter() - t_phase:.1f} s")
    for k in ("memory_topk", "memory_top1", "ivf_route", "ivf_scan",
              "flash_attention", "decode_attention"):
        if counts[k] == 0:
            raise AssertionError(f"Phase M never launched {k}")
    return counts, results


# ---------------------------------------------------------------------------
# Trace: where the card's time goes (run on its own, not by main())
# ---------------------------------------------------------------------------

OUR_KERNELS = ("topk_scan_kernel", "top1_scan_kernel", "route_kernel",
               "ivf_scan_kernel", "flash_kernel", "decode_kernel",
               "moe_grouped_kernel", "moe_combine_kernel")


def _trace_summary(torch, tag, fn, n_steps):
    """Profile ``fn()`` and print its wall time unprofiled and profiled,
    the card's busy time (some kernel or copy running) against both, and
    device time by kind and by kernel."""
    from torch.profiler import ProfilerActivity, profile

    path = ROOT / "build" / "trace" / f"{tag}.json"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    from repro_torch.kernels import ops
    ops.reset_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    counted = sum(ops.launch_counts().values())
    events = device_events(prof, path)
    busy = union_us(events)
    by_name, by_kind = {}, {}
    for e in events:
        name = e["name"].removeprefix("void ")[:70]
        kind = ("port kernels" if any(k in name for k in OUR_KERNELS) else
                "GEMM" if any(k in name.lower() for k in
                              ("gemm", "gemv", "xmma", "cutlass",
                               "nvjet", "cublas")) else
                "copies" if e["cat"] != "kernel" else "other kernels")
        for d, key in ((by_name, name), (by_kind, kind)):
            n, us = d.get(key, (0, 0.0))
            d[key] = (n + 1, us + e["dur"])
    log(f"T {tag}: wall {plain_ms:.3f} ms unprofiled, {wall_ms:.3f} ms "
        f"profiled, over {n_steps} steps; card busy {busy / 1e3:.3f} ms "
        f"({100 * busy / 1e3 / plain_ms:.1f}% of the unprofiled wall); "
        f"{len(events)} device ops ({len(events) / n_steps:.1f} per step)")
    for d, top in ((by_kind, 4), (by_name, 12)):
        for key, (n, us) in sorted(d.items(), key=lambda kv: -kv[1][1])[:top]:
            log(f"T {tag}:   {us / 1e3:9.3f} ms  {n:6d} x  {key}")
    for key, (n, us) in sorted(by_name.items()):
        if any(k in key for k in OUR_KERNELS):
            log(f"T {tag}: port kernel {us / 1e3:.3f} ms over {n} launches "
                f"({us / n:.2f} us each)  {key}")
    # the trace's coverage: the port's launches it holds, against the
    # wrappers' own count over the profiled run (all threads and streams)
    log(f"T {tag}: port kernel launches in the trace "
        f"{by_kind.get('port kernels', (0, 0))[0]}, counted by the wrappers "
        f"{counted}")


def trace(parts=("rar", "ivf", "train", "llama")) -> int:
    """Profile the main paths once each (after a warm-up run): ``rar``,
    the RAR microbatch path at microbatch 8 and 32 (hash embeddings);
    ``ivf``, the same serving against Phase I2's IVF store at microbatch 8
    and 32, and the IVF read alone (B=32, k=4: 20 reads) beside the exact
    scan's; ``train``, 10 AdamW steps of rar-weak at batch 96 and 10 Adam
    steps of the embedder (Phase S1's steps); ``llama``, llama3-8b serving
    one 130-token request with ``max_new`` 8, whose prefill and decode
    steps are also timed apart on the host clock; ``async`` (not in the
    default), R1's workload at microbatch 8 served inline, deferred at
    flush-every 4 (Phase A2's cadence) and with the async drainer at
    flush-every 4, unjournaled and with no drain delay, barrier and
    drainer stop included::

        python3 -c "import chip_smoke; chip_smoke.trace()"
    """
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("trace needs a CUDA card")
    from repro_torch.configs import llama3_8b, rar_system
    from repro_torch.kernels import _build
    from repro_torch.models import init_params, prefill
    from repro_torch.serving.engine import ServingEngine, greedy_generate

    _build.lib()
    log(f"card: {card_line()}")
    cuda = torch.device(DEV)
    vocab, prompts, greqs, embs = workload()
    tiers = (init_params(rar_system.WEAK, SEEDS["weak"], device=cuda),
             init_params(rar_system.STRONG, SEEDS["strong"], device=cuda))
    for mode, flush in ((("inline", 1), ("deferred", A2_FLUSH),
                         ("async", A2_FLUSH)) if "async" in parts else ()):
        cfg = rar_system.make_rar_config(shadow_mode=mode,
                                         shadow_flush_every=flush)

        def run():
            c = serve_rar(cuda, tiers, None, MICROBATCHES[0], prompts, greqs,
                          embs, vocab, cfg=cfg)
            c[0].close_shadow(timeout=WAIT_S)
        run()
        _trace_summary(torch, f"{mode}_mb{MICROBATCHES[0]}", run,
                       PASSES * POOL // MICROBATCHES[0])
    for mb in MICROBATCHES if "rar" in parts else ():
        def run():
            serve_rar(cuda, tiers, None, mb, prompts, greqs, embs, vocab)
        run()
        _trace_summary(torch, f"rar_mb{mb}", run, PASSES * POOL // mb)
    if "ivf" in parts:
        from repro_torch.core.memory_ivf import wrap_store
        cfg, full_store, rng, protos, _ = i2_store(torch)
        for mb in MICROBATCHES:
            # a fresh indexed store for each of the three runs, built (the
            # host k-means) outside them
            stores = [wrap_store(full_store(cuda), cfg) for _ in range(3)]

            def run():
                serve_rar(cuda, tiers, None, mb, prompts, greqs, embs, vocab,
                          cfg=cfg, memory=stores.pop())
            run()
            _trace_summary(torch, f"ivf_i2_mb{mb}", run, PASSES * POOL // mb)
        ivf = serve_rar(cuda, tiers, None, MICROBATCHES[-1], prompts, greqs,
                        embs, vocab, cfg=cfg,
                        memory=full_store(cuda))[0].memory
        q32 = torch.from_numpy(near(rng, protos, 32)).to(cuda)
        for tag, read in (("ivf_read_B32_k4", ivf.query_topk_batch),
                          ("exact_read_B32_k4", ivf.exact_query_topk_batch)):
            read(q32, 4)
            _trace_summary(torch, tag, lambda: [read(q32, 4)
                                                for _ in range(20)], 20)
    if "train" in parts:
        from repro_torch.core import embedder
        from repro_torch.data.tasks import TaskSuite
        from repro_torch.experiments.setup import lm_optimizer
        from repro_torch.training import init_opt_state, make_train_step
        suite, rng = TaskSuite(), np.random.default_rng(0)
        lm = make_train_step(rar_system.WEAK, lm_optimizer(900))
        lm_batches = [suite.weak_train_batch(rng, 96) for _ in range(10)]
        emb_step = embedder.make_train_step(rar_system.EMBEDDER)
        emb_batches = [suite.embedder_batch(rng, 48) for _ in range(10)]
        emb = embedder.init_params(rar_system.EMBEDDER, SEEDS["embedder"],
                                   device=cuda)
        state = {"lm": (tiers[0], init_opt_state(tiers[0])),
                 "emb": (emb, embedder.init_opt(emb))}

        def train_lm():
            p, o = state["lm"]
            for b in lm_batches:
                p, o, m = lm(p, o, b)
            state["lm"] = (p, o)
            return float(m["loss"])

        def train_emb():
            p, o = state["emb"]
            for toks, sids in emb_batches:
                p, o, loss = emb_step(p, o, toks, sids)
            state["emb"] = (p, o)
            return float(loss)
        for tag, run in (("train_weak_x10", train_lm),
                         ("train_embedder_x10", train_emb)):
            run()
            _trace_summary(torch, tag, run, 10)
    if "llama" not in parts:
        return 0

    cfg = getattr(llama3_8b, LLAMA_CONFIG)
    params = init_params(cfg, SEEDS["llama"], device=cuda)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        1, cfg.vocab_size, (1, 130))).to(cuda)
    engine = ServingEngine(cfg, params)

    def serve():
        engine.generate({"tokens": toks}, LLAMA_MAX_NEW)
    serve()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prefill(cfg, params, {"tokens": toks}, 130 + LLAMA_MAX_NEW)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    greedy_generate(cfg, params, {"tokens": toks}, LLAMA_MAX_NEW)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    step = ((t2 - t1) - (t1 - t0)) / (LLAMA_MAX_NEW - 1)
    log(f"T llama3-8b: prefill of 130 tokens {(t1 - t0) * 1e3:.3f} ms; "
        f"decode step {step * 1e3:.3f} ms (host clock, B=1)")
    _trace_summary(torch, "llama3-8b", serve, LLAMA_MAX_NEW)
    return 0


# ---------------------------------------------------------------------------


MAIN_SHAPE = {"memory_topk": "C=4096 E=384 B=32 k=1",
              "memory_top1": "C=65536 E=384 B=32 required=1",
              "ivf_route": "P=1024 E=384 B=8 n_probe=4",
              "ivf_scan": "C=65536 P=1024 n_probe=4 M=256 B=8 k=1",
              "flash_attention": "llama3-8b B=1 Sq=300 H=32 KV=8 hd=128 "
                                 "bfloat16 window=0 causal=True",
              "decode_attention": "llama3-8b B=1 M=308 cache_len=301 H=32 "
                                  "KV=8 hd=128 bfloat16 window=0",
              "moe_grouped": "OLMoE B=4 S=4096 N=131072 bf16"}
SOURCES = {"memory_topk": ("src/repro_torch/kernels/csrc/memory_topk.cu",
                           "src/repro/kernels/memory_topk.py:345"),
           "memory_top1": ("src/repro_torch/kernels/csrc/memory_top1.cu",
                           "src/repro/kernels/memory_topk.py:301"),
           "ivf_route": ("src/repro_torch/kernels/csrc/ivf_route.cu",
                         "src/repro/kernels/memory_ivf.py:74"),
           # the counterpart of _ivf_topk_batch_jit (no Pallas body)
           "ivf_scan": ("src/repro_torch/kernels/csrc/ivf_scan.cu",
                        "src/repro/core/memory_ivf.py:187"),
           "flash_attention": (
               "src/repro_torch/kernels/csrc/flash_attention.cu",
               "src/repro/kernels/flash_attention.py:85"),
           "decode_attention": (
               "src/repro_torch/kernels/csrc/decode_attention.cu",
               "src/repro/kernels/decode_attention.py:75"),
           # no Pallas kernel: JAX leaves the expert products to XLA
           "moe_grouped": ("src/repro_torch/kernels/csrc/moe_grouped.cu",
                           "none (src/repro/models/layers.py::moe)")}


def ptxas_summary(build) -> list[str]:
    """One line a kernel instantiation of the two attention sources from
    the build's ``-Xptxas -v`` log: registers, stack, spill stores and
    loads."""
    import re
    pat = re.compile(r"(flash_kernel_bf16|flash_kernel_f32|decode_kernel)I"
                     r"(13__nv_bfloat16|f)?Li(\d+)E(?:Lb(\d))?")
    out = []
    for src in ("flash_attention.cu", "decode_attention.cu"):
        name, info = None, []
        for line in build.ptxas_report(src) + ["Compiling entry"]:
            if "Compiling entry" in line:
                if name:
                    out.append(f"{name}: {'; '.join(info)}")
                m = pat.search(line)
                name = m and (f"{m[1]}<{'bf16' if m[2] == '13__nv_bfloat16' else 'f32' if m[2] else ''}"
                              f"{',' if m[2] else ''}{m[3]}"
                              f"{',ring' if m[4] == '1' else ''}>")
                info = []
            elif name:
                info.append(line)
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card visible", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build, ops

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = card_line()
    log(f"card: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    _build.lib()
    log(f"build: {time.perf_counter() - t0:.1f} s for "
        f"{len(_build.SOURCES)} CUDA sources -> {_build.library_path()}")
    for line in ptxas_summary(_build):
        log(f"ptxas {line}")

    rows = phase_k(torch)
    e_rows, _ = phase_e(torch, ops)
    rows.update(e_rows)
    r_counts, r_results, tiers = phase_r(torch, ops)
    i_counts, i_results = phase_i(torch, ops, tiers, r_results)
    a_counts, _ = phase_a(torch, ops, tiers, r_results)
    f_counts, _ = phase_f(torch, ops, tiers, r_results)
    m_counts, _ = phase_m(torch, ops, tiers, r_results, i_results)
    del i_results
    l_counts, _ = phase_l(torch, ops)
    z_counts, _ = phase_z(torch, ops)
    t_counts, _ = phase_t(torch, ops)
    phase_d()
    s_counts, s_results = phase_s(torch, ops)
    a4_counts, _ = phase_a4(torch, ops, s_results["system"])
    f5_counts, _ = phase_f5(torch, ops, s_results["system"])
    del s_results
    p_counts, p_results = phase_p(torch, ops)
    g_counts, _ = phase_g(torch, ops, p_results.pop("system"))

    kernels = []
    for name in SOURCES:
        main_row = next(r for r in rows[name] if r["key"] == MAIN_SHAPE[name])
        src, replaces = SOURCES[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces,
            "launches": sum(c.get(name, 0)
                            for c in (r_counts, i_counts, a_counts, f_counts,
                                      m_counts, l_counts, z_counts, t_counts,
                                      s_counts, a4_counts, f5_counts,
                                      p_counts, g_counts)),
            "max_abs_err": max(r["err"] for r in rows[name]),
            "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"],
            "library_ms": main_row["library_ms"], "shape": MAIN_SHAPE[name],
            **{k: main_row[k] for k in ("device_ms", "library_device_ms",
                                        "cold_ms", "library_cold_ms")
               if k in main_row}})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
