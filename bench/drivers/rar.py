"""The RAR controller (``MicrobatchRAR.process_batch``) serving a closed
loop of callers over a guide store at deployment size, judged against the
plain controller of :mod:`bench.reference.plain_rar`.

Set-up: the kernels (built once per checkout); the configuration's
weights (``weights.file``, its digest checked) into the measured
package's tiers, embedder and learned router; the store, its filler rows
committed in chunks (unit vectors from the seed: valid, no guide, not
hard); the filler guard (the largest cosine between any filler row and
the embedding of any question of the universe must stay under the
routing threshold, so filler rows cost the scan and never decide a
route); each FM shape the traffic can send; the traffic's warm-up steps.

Window: a step hands ``microbatch`` requests to ``process_batch``; each
request's latency runs from the hand-over until its Outcome is back. The
benchmark's spans time the embedder and the tiers from around the objects
it hands to the controller; a subclass records each store read's host
result, and a proxy engine each FM call's prompts and tokens.

After the window: the learned rows are read back, the measured system is
freed, and the plain controller replays every step (warm-up and window)
against the logs.
"""
from __future__ import annotations

import functools
import gc
import time

import numpy as np

from bench.harness import flops as hflops
from bench.harness import traffic as htraffic
from bench.harness.checks import held
from bench.harness.manifest import ROOT
from bench.harness.record import Context, Record
from bench.reference import npz, numerics, plain_rar
from bench.reference.tasks import Universe


def filler_chunks(config: dict, seed: int, device):
    """The filler rows, (first row, rows (R, E) float32 unit vectors), from
    one device generator seeded by the run's seed: the same rows each time
    they are drawn again."""
    import torch
    f = config["filler"]
    E = config["memory"]["embed_dim"]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    for first in range(0, f["rows"], f["commit_rows"]):
        n = min(f["commit_rows"], f["rows"] - first)
        rows = torch.randn((n, E), generator=gen, device=device)
        yield first, rows / rows.norm(dim=1, keepdim=True)


def guard_max_cos(u_embs, config: dict, seed: int, device) -> float:
    """The largest cosine between a filler row and a universe question."""
    best = -2.0
    with numerics.exact_f32():
        for _, rows in filler_chunks(config, seed, device):
            best = max(best, float((u_embs @ rows.T).max()))
    return best


class Engine:
    """A proxy around a tier's serving engine: times each sweep and logs
    its prompts and tokens; everything else passes through."""

    def __init__(self, inner, tier: str, spans, log: list):
        self.inner, self.tier, self.spans, self.log = inner, tier, spans, log

    def generate_bucketed(self, prompts, max_new):
        with self.spans.span(f"tier.{self.tier}"):
            out = self.inner.generate_bucketed(prompts, max_new)
        self.log.append((self.tier, max_new, list(prompts), np.array(out)))
        return out

    def __getattr__(self, name):
        return getattr(self.inner, name)


def _assemble(ctx: Context, rec: Record, universe):
    import torch
    from repro_torch import bridge
    from repro_torch.core import embedder as pemb
    from repro_torch.core import memory as mem
    from repro_torch.core.fm import FMTier
    from repro_torch.core.pipeline import MicrobatchRAR
    from repro_torch.core.rar import RARConfig
    from repro_torch.core.router import LearnedRouter
    from repro_torch.data.tasks import TaskSuite, TaskSuiteConfig
    from repro_torch.data.tokenizer import Vocab
    from repro_torch.experiments.setup import TrainedSystem
    from repro_torch.training.checkpoint import load_checkpoint

    from bench.drivers.lm import model_config
    cfg, dev = ctx.config, ctx.device
    path = ROOT / cfg["weights"]["file"]
    if npz.sha256(path) != cfg["weights"]["sha256"]:
        raise SystemExit(f"{path}: not the weights this configuration "
                         f"names (sha256 {cfg['weights']['sha256']})")
    blob = load_checkpoint(str(path), device="cpu")
    wcfg, scfg = model_config(cfg["weak"]), model_config(cfg["strong"])
    ecfg = pemb.EmbedderConfig(**cfg["embedder"])
    vocab = Vocab(n_domains=cfg["suite"]["n_domains"])
    weak = FMTier.create("weak", wcfg, bridge.lm_params(wcfg, blob["weak"],
                                                        dev), vocab)
    strong = FMTier.create("strong", scfg, bridge.lm_params(
        scfg, blob["strong"], dev), vocab)
    eparams = bridge.embedder_params(ecfg, blob["embedder"], dev)
    w, b = bridge.router(blob["router_w"], blob["router_b"], ecfg.embed_dim,
                         dev)
    suite_cfg = {k: cfg["suite"][k] for k in (
        "n_domains", "skills_per_domain", "shared_skills", "max_operand",
        "seq_len")}
    system = TrainedSystem(
        suite=TaskSuite(TaskSuiteConfig(**suite_cfg)), weak=weak,
        strong=strong, embedder_params=eparams,
        router=LearnedRouter(w=w, b=b),
        embed_batch_fn=functools.partial(pemb.embed, ecfg, eparams))

    mcfg = mem.MemoryConfig(**cfg["memory"])
    store = mem.init_memory(mcfg, device=dev)
    G = mcfg.guide_len
    for _, rows in filler_chunks(cfg, ctx.seed, dev):
        n = rows.shape[0]
        mem.add_batch(store, rows, torch.zeros((n, G), dtype=torch.int32,
                                               device=dev),
                      torch.zeros(n, dtype=torch.bool, device=dev),
                      torch.zeros(n, dtype=torch.bool, device=dev),
                      torch.zeros(n, dtype=torch.int32, device=dev))
    u_embs = torch.as_tensor(system.embed_many(universe.prompts), device=dev)
    rec.counters["filler_guard"] = guard_max_cos(u_embs, cfg, ctx.seed, dev)
    del u_embs
    thr = cfg["rar"]["sim_threshold"]
    print(f"filler guard: largest cosine of a filler row to a question "
          f"{rec.counters['filler_guard']:.6f}, limit {thr}", flush=True)
    if rec.counters["filler_guard"] >= thr:
        raise SystemExit("filler guard: a filler row reaches the routing "
                         "threshold")

    # every FM shape the traffic can send: answers of bare and guided
    # prompts and guide generations, at each bucket of the microbatch
    B = ctx.traffic["microbatch"]
    q = universe.prompts[0]
    guide = np.asarray([cfg["vocab"]["GUIDE_START"]] + [q[2]] * 2 +
                       [cfg["vocab"]["GUIDE_END"]], np.int32)
    guided = plain_rar.splice(q, [guide] * cfg["rar"]["max_guides"],
                              cfg["vocab"]["PAD"])
    n = 1
    while n <= B:
        for p in ([q], [guided]):
            weak.answer_many(p * n)
        strong.answer_many([q] * n)
        strong.generate_guides_many([universe.guide_requests[0]] * n, G)
        n *= 2

    class Recording(MicrobatchRAR):
        reads: list | None = None

        def _lookup_batch(self, embs, guides_only=False):
            res = super()._lookup_batch(embs, guides_only=guides_only)
            if self.reads is not None:
                self.reads.append((guides_only, np.array(res.sim),
                                   np.array(res.index)))
            return res

    calls, embs = [], []

    def embed_batch(prompts):
        with rec.spans.span("embedder"):
            e = system.embed_many(prompts)
        embs.append(e)
        return e

    weak.engine = Engine(weak.engine, "weak", rec.spans, calls)
    strong.engine = Engine(strong.engine, "strong", rec.spans, calls)
    ctrl = Recording(weak, strong, system.embed_one,
                     lambda emb, key: system.router.route_weak(emb),
                     RARConfig(memory=mcfg, **cfg["rar"]), memory=store,
                     device=dev, embed_batch_fn=embed_batch)
    ctrl.reads = []
    return ctrl, calls, embs


def run(ctx: Context) -> Record:
    import torch
    rec = Record()
    dev = ctx.device
    cfg = ctx.config
    if dev.type == "cuda":
        from repro_torch.kernels import _build
        _build.lib()
    universe = Universe(cfg)
    stream = htraffic.make(ctx.traffic, cfg, ctx.seed, universe=universe)
    ctrl, calls, embs = _assemble(ctx, rec, universe)
    F = cfg["filler"]["rows"]
    logs, qids_all = [], []

    def serve(qids) -> int:
        prompts = [universe.prompts[int(q)] for q in qids]
        greqs = [universe.guide_requests[int(q)] for q in qids]
        del calls[:], embs[:], ctrl.reads[:]
        outs = ctrl.process_batch(prompts, greqs)
        logs.append(plain_rar.StepLog(
            embs[0], list(ctrl.reads), list(calls),
            [None if o is None else (o.response, o.served_by, o.strong_calls,
                                     o.case, o.guide_source) for o in outs]))
        qids_all.append(qids)
        rec.failed += sum(o is None or o.case == "shadow_pending"
                          for o in outs)
        return len(outs)

    for qids in stream.warmup_items():
        serve(qids)
    rec.failed = 0
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    hist = ctrl.metrics_registry.histogram("shadow/drain_seconds")
    drain0, strong0 = hist.total, ctrl.strong.engine.calls
    first = len(logs)
    ctx.measure(rec, stream, serve)
    rec.requests = rec.attempted = rec.steps * stream.B
    rec.counters["strong_calls"] = ctrl.strong.engine.calls - strong0
    rec.counters["drain_s"] = hist.total - drain0
    rec.counters["learned_rows"] = ctrl.memory.ptr - F
    if dev.type == "cuda":
        rec.memory_peak = torch.cuda.max_memory_allocated(dev)
    rec.flops = window_flops(cfg, logs[first:], qids_all[first:], universe)

    # the learned rows, read back; then the system goes
    st = ctrl.memory
    E = cfg["memory"]["embed_dim"]
    lo, hi = F, min(st.ptr, st.capacity)
    learned = {}
    if hi > lo:
        emb = st.emb[lo:hi, :E].cpu().numpy()
        mask = st.mask[lo:hi, 0].cpu().numpy()
        guide = st.guide[lo:hi].cpu().numpy()
        hard = st.hard[lo:hi].cpu().numpy()
        added = st.added_at[lo:hi].cpu().numpy()
        for j in range(hi - lo):
            learned[lo + j] = {"emb": emb[j], "guide": guide[j],
                               "has_guide": bool(mask[j] & 2),
                               "hard": bool(hard[j]),
                               "added_at": int(added[j])}
    if st.ptr > st.capacity:
        rec.notes.append("the ring wrapped onto the filler rows")
    del ctrl, st
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    numbers = judge(ctx, universe, qids_all, logs, learned, rec)
    rec.counters["reference_s"] = time.perf_counter() - t_ref
    rec.checks = held(ctx.cell.name, numbers)
    return rec


def window_flops(cfg: dict, logs, qids_all, universe) -> float:
    """Operations the window's work needs: the embedder over each request's
    tokens, every FM call's rows (bucket padding not counted), each store
    read's 2 B C E."""
    total = 0.0
    C, E = cfg["memory"]["capacity"], cfg["memory"]["embed_dim"]
    for qids, log in zip(qids_all, logs):
        total += hflops.encoder_flops(
            cfg["embedder"], [len(universe.prompts[int(q)]) for q in qids], E)
        for tier, max_new, prompts, _ in log.calls:
            total += hflops.generate_flops(cfg[tier],
                                           [len(p) for p in prompts], max_new)
        for _, sims, _ in log.reads:
            total += 2.0 * sims.shape[0] * C * E
    return total


def judge(ctx, universe, qids_all, logs, learned, rec) -> dict:
    """Replay every step with the plain controller against its log."""
    import torch
    dev = ctx.device
    cfg = ctx.config
    params = npz.load(ROOT / cfg["weights"]["file"], device=dev)
    k1 = cfg["rar"]["retrieval_k"] + 1
    with numerics.exact_f32(), torch.no_grad():
        from bench.reference import plain_lm
        toks = torch.as_tensor(universe.padded(), device=dev)
        u_embs = plain_lm.embed(cfg["embedder"], params["embedder"], toks,
                                pad=cfg["vocab"]["PAD"])
        table = plain_rar.filler_top(u_embs, filler_chunks(cfg, ctx.seed, dev),
                                     k1)
        ref = plain_rar.PlainRAR(cfg, params, universe, u_embs, table, dev)
        try:
            for qids, log in zip(qids_all, logs):
                ref.process_batch(qids, forced=log)
            ref.compare_store(learned)
        except plain_rar.Diverged as e:
            ref.checks.note(str(e))
        except Exception as e:       # a log the reference cannot read
            ref.checks.call_miss += 1
            ref.checks.note(f"the reference stopped: {e!r}")
    rec.notes += ref.checks.notes
    numbers = ref.checks.numbers()
    numbers["strong_calls_diff"] = abs(
        sum(len(c[2]) for log in logs for c in log.calls if c[0] == "strong")
        - ref.strong_calls)
    return numbers
