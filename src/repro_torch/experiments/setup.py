"""Train and assemble the full RAR evaluation system: the counterpart of
``src/repro/experiments/setup.py``.

The weak/strong FMs (trained with :mod:`repro_torch.training`), the
contrastive embedder, the learned static router and the evaluation pools
("failing samples" subsets mirroring the paper's MMLU selection, Fig. 3).
Training runs on ``device`` (the card by default) with the model-level
attention; everything forward-only after it (profiling the weak FM for the
router, the pools, the embeddings, serving) runs on the kernels, with
parameters that require no grad.

Seeds follow the JAX package's: ``seed`` initializes the weak FM (a
``torch.Generator``, so other numbers than ``jax.random``'s) and draws its
batches (numpy ``default_rng``), ``seed + 1`` the strong FM, ``seed + 7``
the embedder, ``seed + 100`` the router's profiling set. The system is
cached under ``.cache/rar_system_torch/`` (``REPRO_TORCH_CACHE``) in the
port's own checkpoint format; the JAX package's cache is never read.
"""
from __future__ import annotations

import dataclasses
import functools
import os
import time
from typing import Any

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.configs import rar_system
from repro_torch.core import embedder as emb
from repro_torch.core.fm import FMTier
from repro_torch.core.router import LearnedRouter, train_router
from repro_torch.data.tasks import TaskSuite, TaskSuiteConfig
from repro_torch.device import resolve_device
from repro_torch.models import init_params
from repro_torch.training import (AdamWConfig, init_opt_state,
                                  load_checkpoint, make_train_step,
                                  save_checkpoint)

CACHE_DIR = os.environ.get("REPRO_TORCH_CACHE", ".cache/rar_system_torch")
N_PROFILE = 600          # weak-FM profiling prompts for the learned router

print = functools.partial(print, flush=True)  # noqa: A001 — logs stream to files


@dataclasses.dataclass
class TrainedSystem:
    suite: TaskSuite
    weak: FMTier
    strong: FMTier
    embedder_params: Any
    router: LearnedRouter
    embed_batch_fn: Any            # (B, L) tokens -> (B, 384) tensor
    #: what training measured, per part (``weak``, ``strong``,
    #: ``embedder``, ``router``): wall seconds, steps, final loss and
    #: accuracy; empty for a system loaded or bridged
    train_stats: dict = dataclasses.field(default_factory=dict)

    # ------------------------------------------------------------------
    def embed_one(self, prompt: np.ndarray) -> np.ndarray:
        return self.embed_many([prompt])[0]

    def embed_many(self, prompts: list[np.ndarray]) -> np.ndarray:
        L = self.suite.cfg.seq_len
        padded = np.zeros((len(prompts), L), np.int32)
        for i, p in enumerate(prompts):
            padded[i, :len(p)] = p
        out = self.embed_batch_fn(padded)
        tracing.count("host_sync.embed")
        return out.cpu().numpy()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# ---------------------------------------------------------------------------
# FM training
# ---------------------------------------------------------------------------


def lm_optimizer(steps: int, lr: float = 1e-3) -> AdamWConfig:
    """The FMs' AdamW: 50 warmup steps, cosine decay over ``steps``."""
    return AdamWConfig(learning_rate=lr, warmup_steps=50, total_steps=steps,
                       weight_decay=0.01, beta2=0.98)


def _train_lm(cfg, batch_fn, steps: int, batch_size: int, seed: int,
              lr: float = 1e-3, log_every: int = 200,
              device="cuda") -> tuple[Any, dict]:
    """Train one LM from ``init_params(cfg, seed)``; returns the
    parameters and a summary (seconds, steps, final loss and accuracy)."""
    dev = resolve_device(device)
    params = init_params(cfg, seed, device=dev)
    opt_state = init_opt_state(params)
    step_fn = make_train_step(cfg, lm_optimizer(steps, lr))
    rng = np.random.default_rng(seed)
    metrics: dict = {}
    t0 = time.perf_counter()
    for i in range(steps):
        batch = batch_fn(rng, batch_size)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if log_every and (i + 1) % log_every == 0:
            print(f"  [{cfg.name}] step {i + 1}/{steps} "
                  f"loss={float(metrics['loss']):.4f} "
                  f"acc={float(metrics['accuracy']):.3f} "
                  f"({time.perf_counter() - t0:.0f}s)")
    _sync(dev)
    return params, {"seconds": time.perf_counter() - t0, "steps": steps,
                    "loss": float(metrics["loss"]) if steps else None,
                    "accuracy": float(metrics["accuracy"]) if steps
                    else None}


def _train_embedder(ecfg, suite: TaskSuite, steps: int, batch_pairs: int,
                    seed: int, device="cuda") -> tuple[Any, dict]:
    dev = resolve_device(device)
    params = emb.init_params(ecfg, seed + 7, device=dev)
    opt = emb.init_opt(params)
    step = emb.make_train_step(ecfg)
    rng = np.random.default_rng(seed + 7)
    loss = None
    t0 = time.perf_counter()
    for i in range(steps):
        toks, sids = suite.embedder_batch(rng, batch_pairs)
        params, opt, loss = step(params, opt, toks, sids)
        if (i + 1) % 200 == 0:
            print(f"  [embedder] step {i + 1}/{steps} "
                  f"ntxent={float(loss):.4f}")
    _sync(dev)
    return params, {"seconds": time.perf_counter() - t0, "steps": steps,
                    "loss": None if loss is None else float(loss)}


# ---------------------------------------------------------------------------
# System assembly
# ---------------------------------------------------------------------------


def build_system(suite_cfg: TaskSuiteConfig = TaskSuiteConfig(), *,
                 weak_steps: int = 900, strong_steps: int = 1100,
                 embedder_steps: int = 400, batch_size: int = 96,
                 seed: int = 0, cache: bool = True, verbose: bool = True,
                 device="cuda", params: dict | None = None) -> TrainedSystem:
    """Train (or load) the system on ``device``. ``params`` — a dict of
    ``weak``, ``strong``, ``embedder``, ``router_w`` and ``router_b`` as
    :func:`repro_torch.bridge.system` gives it — skips training and the
    cache: the system is assembled from those parameters."""
    dev = resolve_device(device)
    suite = TaskSuite(suite_cfg)
    ckpt = os.path.join(
        CACHE_DIR,
        f"sys_{suite_cfg.seed}_{suite_cfg.guide_train_frac}_{weak_steps}_"
        f"{strong_steps}_{seed}.npz")
    stats: dict = {}
    router = None
    if params is None and cache and os.path.exists(ckpt):
        if verbose:
            print(f"[setup] loading cached system from {ckpt}")
        params = load_checkpoint(ckpt, device=dev)
    if params is not None:
        weak_params, strong_params = params["weak"], params["strong"]
        embedder_params = params["embedder"]
        router = LearnedRouter(w=params["router_w"], b=params["router_b"])
    else:
        if verbose:
            print("[setup] training weak FM "
                  f"({rar_system.WEAK.param_count():,} params)")
        weak_params, stats["weak"] = _train_lm(
            rar_system.WEAK, suite.weak_train_batch, weak_steps, batch_size,
            seed, device=dev)
        if verbose:
            print("[setup] training strong FM "
                  f"({rar_system.STRONG.param_count():,} params)")
        strong_params, stats["strong"] = _train_lm(
            rar_system.STRONG, suite.strong_train_batch, strong_steps,
            batch_size, seed + 1, device=dev)
        if verbose:
            print("[setup] training contrastive embedder")
        embedder_params, stats["embedder"] = _train_embedder(
            rar_system.EMBEDDER, suite, embedder_steps, 48, seed,
            device=dev)

    embed_fn = functools.partial(emb.embed, rar_system.EMBEDDER,
                                 embedder_params)
    weak = FMTier.create("weak", rar_system.WEAK, weak_params, suite.vocab)
    strong = FMTier.create("strong", rar_system.STRONG, strong_params,
                           suite.vocab)

    if router is None:
        if verbose:
            print("[setup] profiling weak FM + training static router")
        t0 = time.perf_counter()
        router = _build_learned_router(suite, weak, embed_fn, seed,
                                       device=dev)
        _sync(dev)
        stats["router"] = {"seconds": time.perf_counter() - t0,
                           "n_profile": N_PROFILE}
        if cache:
            save_checkpoint(ckpt, {
                "weak": weak_params, "strong": strong_params,
                "embedder": embedder_params,
                "router_w": router.w, "router_b": router.b})
            if verbose:
                print(f"[setup] cached system at {ckpt}")

    return TrainedSystem(suite=suite, weak=weak, strong=strong,
                         embedder_params=embedder_params, router=router,
                         embed_batch_fn=embed_fn, train_stats=stats)


def _build_learned_router(suite: TaskSuite, weak: FMTier, embed_fn,
                          seed: int, n_profile: int = N_PROFILE,
                          device="cuda") -> LearnedRouter:
    """RouteLLM analog: profile the weak FM on held-out questions and fit
    a logistic router on (embedding → success)."""
    rng = np.random.default_rng(seed + 100)
    prompts, labels = [], []
    L = suite.cfg.seq_len
    for _ in range(n_profile):
        d = int(rng.integers(0, suite.cfg.n_domains))
        s = int(rng.choice(suite.domain_skills[d]))
        x = int(rng.integers(0, suite.cfg.max_operand))
        prompts.append(np.asarray(suite.vocab.question(d, s, x), np.int32))
        labels.append(suite.answer(s, x))
    maxlen = max(len(p) for p in prompts)
    batch = np.zeros((n_profile, maxlen), np.int32)
    for i, p in enumerate(prompts):
        batch[i, :len(p)] = p
    # uniform length in this suite → answer in one batched call
    ans = weak.answer_batch(batch)
    success = (ans == np.asarray(labels)).astype(np.float32)
    padded = np.zeros((n_profile, L), np.int32)
    padded[:, :maxlen] = batch
    embs = embed_fn(padded).cpu().numpy()
    return train_router(embs, success, device=device)


# ---------------------------------------------------------------------------
# Evaluation pools — the paper's "failing samples" subsets (Fig. 3)
# ---------------------------------------------------------------------------

POOL_SIZES = {0: 754, 1: 359, 2: 675}   # prof. law / HS psych / moral scen.
POOL_NAMES = {0: "professional_law", 1: "high_school_psychology",
              2: "moral_scenarios"}


def failing_pool(system: TrainedSystem, domain: int, *,
                 n: int | None = None, seed: int = 1234
                 ) -> list[tuple[int, int, int]]:
    """Questions of one domain that the weak FM fails unaided — the
    paper's data selection (weak-FM-failed subsets of MMLU)."""
    n = n or POOL_SIZES[domain]
    suite = system.suite
    cands = suite.question_pool(domain, int(n * 2.2), seed)
    prompts = np.stack([
        np.asarray(suite.vocab.question(d, s, x), np.int32)
        for d, s, x in cands])
    ans = system.weak.answer_batch(prompts)
    truth = np.asarray([suite.answer(s, x) for _, s, x in cands])
    failing = [c for c, a, t in zip(cands, ans, truth) if a != t]
    if len(failing) < n:
        raise ValueError(f"domain {domain}: {len(failing)} failing "
                         f"questions, fewer than the pool's {n}")
    return failing[:n]
