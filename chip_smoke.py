#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases, each of which fails the run on any error:

* build: compiles the six CUDA kernels from ``src/repro_torch/kernels/
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
  empty cache);
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

The launch counters are zeroed right before each main-path phase (for S,
before S1; A1-A3 together, A4 alone) and read right after it; a kernel of
the path that did not launch fails the run.
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
WAIT_S = 120.0                   # the longest any shadow barrier may take
A2_FLUSH, A2_DELAY = 4, 0.005    # A2: drain cadence and injected delay
A3_SNAPSHOT, A3_CRASH = 3, {"wal": 5, "apply": 8}   # A3: epochs


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
    (cent, cmask, cidmap), st = store._plane, store.store
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
                  kv_len=None):
        g = torch.Generator(device=dev).manual_seed(Sq * 1000 + H)
        q = torch.randn((B, Sq, H, hd), generator=g, device=dev).to(dtype)
        k = torch.randn((B, Sq, KV, hd), generator=g, device=dev).to(dtype)
        v = torch.randn((B, Sq, KV, hd), generator=g, device=dev).to(dtype)
        kl = None if kv_len is None else torch.full(
            (B,), kv_len, dtype=torch.int32, device=dev)
        kw = dict(causal=causal, window=window, kv_len=kl)
        got = fa.flash_attention_cuda(q, k, v, **kw)
        want = fa.flash_attention_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        tol = ATTN_TOL[str(dtype).split(".")[1]]
        if not err <= tol:
            raise AssertionError(f"flash {tag} Sq={Sq}: err {err} > {tol}")
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        mask = None
        if window or kl is not None or not causal:
            pos = torch.arange(Sq, device=dev)
            d = pos[:, None] - pos[None, :]
            mask = torch.ones((Sq, Sq), dtype=torch.bool, device=dev)
            if causal:
                mask &= d >= 0
            if window:
                mask &= d < window
            if kl is not None:
                mask = mask & (pos[None, :] < kv_len)

        def lib():
            return F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, is_causal=mask is None,
                enable_gqa=True)
        pairs = B * H * sum(
            sum(1 for j in range(Sq)
                if (not causal or j <= i) and (not window or i - j < window)
                and (kv_len is None or j < kv_len)) for i in range(Sq))
        es = q.element_size()
        b = bound((2 * q.numel() + 2 * k.numel()) * es, 4 * pairs * hd,
                  BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS)

        def kernel():
            return fa.flash_attention_cuda(q, k, v, **kw)
        key = (f"{tag} B={B} Sq={Sq} H={H} KV={KV} hd={hd} "
               f"{str(dtype)[6:]} window={window} causal={causal}"
               + ("" if kv_len is None else f" kv_len={kv_len}"))
        extra = (card_times(f"flash_Sq{Sq}_w{window}", kernel, lib)
                 if tag == "llama3-8b" else {})
        record("flash_attention", key, err, time_ms(torch, kernel),
               time_ms(torch, lambda: fa.flash_attention_plain(q, k, v,
                                                               **kw)),
               time_ms(torch, lib), b, **extra)

    def decode_case(tag, B, M, cl, H, KV, hd, dtype, window=0):
        """``cl``: one cache length for every row, or a list of B. It goes
        in as a (B,) int32 tensor already on the card, as the model passes
        it, so no timed call pays a host-to-device copy."""
        g = torch.Generator(device=dev).manual_seed(M * 1000 + H)
        q = torch.randn((B, H, hd), generator=g, device=dev).to(dtype)
        k = torch.randn((B, M, KV, hd), generator=g, device=dev).to(dtype)
        v = torch.randn((B, M, KV, hd), generator=g, device=dev).to(dtype)
        lens = [cl] * B if isinstance(cl, int) else list(cl)
        clt = torch.tensor(lens, dtype=torch.int32, device=dev)
        got = da.decode_attention_cuda(q, k, v, clt, window=window)
        want = da.decode_attention_plain(q, k, v, clt, window=window)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        tol = ATTN_TOL[str(dtype).split(".")[1]]
        if not err <= tol:
            raise AssertionError(f"decode {tag} M={M} cache_len={cl}: err "
                                 f"{err} > {tol}")
        spans = [(max(0, n - window) if window else 0, min(M, n))
                 for n in lens]
        qt = q[:, :, None]
        if len(set(lens)) == 1:
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
            return da.decode_attention_cuda(q, k, v, clt, window=window)
        n = sum(hi - lo for lo, hi in spans)
        es = q.element_size()
        b = bound((2 * q.numel() + 2 * n * KV * hd) * es, 4 * H * n * hd,
                  BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS)
        shown = cl if isinstance(cl, int) else list(cl)
        extra = (card_times(f"decode_M{M}_w{window}_B{B}", kernel, lib)
                 if tag == "llama3-8b" else {})
        record("decode_attention",
               f"{tag} B={B} M={M} cache_len={shown} H={H} KV={KV} hd={hd} "
               f"{str(dtype)[6:]} window={window}", err,
               time_ms(torch, kernel),
               time_ms(torch, lambda: da.decode_attention_plain(
                   q, k, v, clt, window=window)),
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
    embeddings computed on either device)."""
    import torch
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
        results[f"I2_mb{mb}"] = dict(strong_calls=strong,
                                     req_per_s=n / c[2])
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
    cent, cmask, cidmap = ivf._plane
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
    rar_strong = sum(r.strong_calls for r in rar_res)
    rar_aligned = sum(r.aligned for r in rar_res)
    fig4 = {
        "strong_call_reduction_vs_oracle": 1.0 - rar_strong / max(
            sum(r.strong_calls for r in base["oracle_router"]), 1),
        "quality_vs_oracle": rar_aligned / n_total,
        "aligned_vs_weak": rar_aligned / max(
            sum(r.aligned for r in base["weak"]), 1),
        "aligned_vs_cot": rar_aligned / max(
            sum(r.aligned for r in base["weak_cot"]), 1)}
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
# Trace: where the card's time goes (run on its own, not by main())
# ---------------------------------------------------------------------------

OUR_KERNELS = ("topk_scan_kernel", "top1_scan_kernel", "route_kernel",
               "ivf_scan_kernel", "flash_kernel", "decode_kernel")


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
    busy, end = 0.0, float("-inf")
    for s, t in sorted((e["ts"], e["ts"] + e["dur"]) for e in events):
        if t > end:
            busy += t - max(s, end)
            end = t
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
                                  "KV=8 hd=128 bfloat16 window=0"}
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
               "src/repro/kernels/decode_attention.py:75")}


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

    rows = phase_k(torch)
    r_counts, r_results, tiers = phase_r(torch, ops)
    i_counts, _ = phase_i(torch, ops, tiers, r_results)
    a_counts, _ = phase_a(torch, ops, tiers, r_results)
    l_counts, _ = phase_l(torch, ops)
    s_counts, s_results = phase_s(torch, ops)
    a4_counts, _ = phase_a4(torch, ops, s_results["system"])

    kernels = []
    for name in SOURCES:
        main_row = next(r for r in rows[name] if r["key"] == MAIN_SHAPE[name])
        src, replaces = SOURCES[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces,
            "launches": sum(c.get(name, 0)
                            for c in (r_counts, i_counts, a_counts, l_counts,
                                      s_counts, a4_counts)),
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
