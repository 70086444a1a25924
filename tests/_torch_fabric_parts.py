"""Picklable replica factories for the port's process-fabric tests.

A spawned worker unpickles its factory by importing this module, so it
imports torch and the port only, never JAX: the workers stay free of the
reference package (``tests/test_torch_isolation.py`` checks a worker's
``sys.modules``). ``FakeTier`` is the rule-based tier of
``tests/test_rar_controller.py``, on the port's tokenizer; ``rar_parts``
builds the rar-weak/rar-strong tiers from their seeds on a device.
"""
import functools
import multiprocessing
import sys

import numpy as np

from repro_torch.data import tokenizer as tk


class CountEngine:
    """Engine counters with the export/restore protocol, so a worker's
    FakeTier calls ship to the parent as deltas and survive a manifest
    recovery."""

    def __init__(self):
        self.calls = 0
        self.tokens_processed = 0

    def export_counters(self):
        return {"calls": self.calls,
                "tokens_processed": self.tokens_processed}

    def restore_counters(self, c):
        self.calls = c["calls"]
        self.tokens_processed = c["tokens_processed"]


class FakeTier:
    """``test_rar_controller.FakeTier``: the answer to [BOS, s, x] is
    (s + x) % 4 for a known skill s, a guided prompt is answered iff its
    hint names the skill, and guides carry the hint iff ``can_guide``."""

    def __init__(self, known=(), can_guide=False, name="fake"):
        self.known = set(known)
        self.can_guide = can_guide
        self.name = name
        self.engine = CountEngine()

    def answer_batch(self, prompts):
        out = []
        for p in prompts:
            self.engine.calls += 1
            p = list(p)
            if len(p) == 6:                      # [BOS, GS, hint, GE, s, x]
                hint, skill, x = p[2], p[4], p[5]
                out.append((skill + x) % 4 if hint == skill + 100 else -1)
            else:                                # [BOS, s, x]
                skill, x = p[1], p[2]
                out.append((skill + x) % 4 if skill in self.known else -1)
        return np.asarray(out)

    def generate_guides(self, requests, guide_len):
        self.engine.calls += len(requests)
        g = np.zeros((len(requests), guide_len), np.int32)
        g[:, 0] = tk.GUIDE_START
        for i, r in enumerate(requests):
            g[i, 1] = r[1] + 100 if self.can_guide else 99999
        g[:, 2] = tk.GUIDE_END
        return g


def no_embed(p):
    return None


def route_false(emb, key):
    return False


def make_parts(weak_known=()):
    """``test_procfabric._make_parts`` on the port's FakeTier."""
    return {"weak": FakeTier(known=weak_known, name="weak"),
            "strong": FakeTier(known=range(10_000), can_guide=True,
                               name="strong"),
            "embed_fn": no_embed, "route_weak_fn": route_false}


def failing_parts(weak_known=()):
    """``make_parts`` in the parent, an error in a worker: a replica
    that cannot be built."""
    if multiprocessing.parent_process() is not None:
        raise RuntimeError("this worker cannot build its replica")
    return make_parts(weak_known)


def jax_free_parts(weak_known=()):
    """``make_parts``, in a worker only if no JAX module is loaded."""
    if multiprocessing.parent_process() is not None:
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "repro"))
        if bad:
            raise RuntimeError(f"worker imported {bad[:5]}")
    return make_parts(weak_known)


def factory(fn=make_parts, weak_known=()):
    return functools.partial(fn, tuple(sorted(weak_known)))


def rar_parts(device, weak_seed=0, strong_seed=1):
    """rar-weak and rar-strong from their seeds on ``device`` (the
    ``rar_throughput`` workload's tiers), with the always-False router."""
    from repro_torch.configs import rar_system
    from repro_torch.core.fm import FMTier
    from repro_torch.models import init_params
    vocab = tk.Vocab(n_domains=3)
    return {"weak": FMTier.create("weak", rar_system.WEAK, init_params(
                rar_system.WEAK, weak_seed, device=device), vocab),
            "strong": FMTier.create("strong", rar_system.STRONG, init_params(
                rar_system.STRONG, strong_seed, device=device), vocab),
            "embed_fn": no_embed, "route_weak_fn": route_false}


def rar_workload(n=64):
    """The ``rar_throughput`` workload (``chip_smoke.workload``): n
    distinct questions, their guide requests and hash embeddings."""
    vocab = tk.Vocab(n_domains=3)
    prompts, greqs, embs = [], [], []
    i = 0
    while len(prompts) < n:
        d, s, x = i % 3, (i // 3) % 16, (i // 48) % 10
        i += 1
        prompts.append(np.asarray(vocab.question(d, s, x), np.int32))
        greqs.append(np.asarray(vocab.guide_request(d, s), np.int32))
        rng = np.random.default_rng(abs(hash((d, s, x))) % (2 ** 31))
        e = rng.normal(size=384).astype(np.float32)
        embs.append(e / np.linalg.norm(e))
    return prompts, greqs, np.stack(embs)
