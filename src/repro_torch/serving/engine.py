"""Batched greedy serving over the port's model: the counterpart of
``src/repro/serving/engine.py``.

PyTorch runs eagerly, so there is no compile cache; the engine still keys
its variants on ``(tokens.shape, max_new)`` as the JAX engine keys its jit
cache, so ``stats()`` (``jit_variants``/``jit_hits``/``jit_misses``) reads
the same on both. Billing is the JAX engine's exactly: ``calls`` counts
logical requests, ``tokens_processed`` physical tokens, bucket padding
rows included.
"""
from __future__ import annotations

import threading
from typing import Any, Sequence

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.models import decode_step, prefill
from repro_torch.models.config import ModelConfig


def bucket_batch(n: int) -> int:
    """Smallest power of two >= n: the batch-dim bucket sizes."""
    b = 1
    while b < n:
        b *= 2
    return b


def greedy_generate(cfg: ModelConfig, params: Any, batch: dict,
                    max_new: int) -> torch.Tensor:
    """Greedy decode ``max_new`` tokens after the (uniform-length) prompts
    ``batch["tokens"]`` (B, Lp), with the family's frontend input
    (``patch_embeds``, ``frames``) beside them; the vlm family's cache
    also holds its ``num_patches`` patch positions. Returns (B, max_new)
    int32 on the params' device. The JAX scan also runs one last decode
    step whose token it drops; this loop stops before it, which changes no
    output."""
    Lp = batch["tokens"].shape[1]
    extra = cfg.num_patches if cfg.family == "vlm" else 0
    logits, cache, pos = prefill(cfg, params, batch, Lp + extra + max_new)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    outs = [tok]
    for _ in range(max_new - 1):
        logits, cache = decode_step(cfg, params, tok, cache, pos)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        outs.append(tok)
        pos += 1
    return torch.stack(outs, dim=1)


def fetch(out: torch.Tensor) -> np.ndarray:
    """A call's tokens on the host: the wait each engine call ends in."""
    with tracing.span("engine.fetch"):
        tracing.count("host_sync.engine")
        return out.cpu().numpy()


class ServingEngine:
    """Greedy serving for one model, with the JAX engine's counters."""

    def __init__(self, cfg: ModelConfig, params: Any):
        self.cfg = cfg
        self.params = params
        self.device = params["embed"].device
        self._variants: set[tuple] = set()
        self.calls = 0
        self.tokens_processed = 0
        self.jit_hits = 0
        self.jit_misses = 0
        self._lock = threading.Lock()

    def _bill(self, calls: int, tokens: int) -> None:
        with self._lock:
            self.calls += calls
            self.tokens_processed += tokens

    @tracing.traced("engine.call")
    def generate(self, batch: dict, max_new: int) -> torch.Tensor:
        """Serve one uniform-length batch (``tokens`` and any frontend
        input, each key passed on to the model); returns (B, max_new)
        int32 on the engine's device."""
        tracing.count("host_sync.engine_upload")
        tokens = torch.as_tensor(batch["tokens"], dtype=torch.int64,
                                 device=self.device)
        key = (tuple(tokens.shape), max_new) + tuple(sorted(
            k for k in batch if k != "tokens"))
        with self._lock:
            if key in self._variants:
                self.jit_hits += 1
            else:
                self.jit_misses += 1
                self._variants.add(key)
        inputs = {k: torch.as_tensor(v, device=self.device)
                  for k, v in batch.items() if k != "tokens"}
        out = greedy_generate(self.cfg, self.params,
                              {**inputs, "tokens": tokens}, max_new)
        self._bill(tokens.shape[0], tokens.numel() + out.numel())
        return out

    def generate_bucketed(self, prompts: Sequence[np.ndarray],
                          max_new: int) -> np.ndarray:
        """Serve a mixed-length prompt list in one sweep: grouped by exact
        length, each group padded along batch to its power-of-two bucket
        (dummy rows repeat the group's first prompt; their outputs are
        dropped and they are not billed as calls). Returns (N, max_new)
        int32 in input order."""
        by_len: dict[int, list[int]] = {}
        for i, p in enumerate(prompts):
            by_len.setdefault(len(p), []).append(i)
        out = np.zeros((len(prompts), max_new), np.int32)
        for _, idxs in sorted(by_len.items()):
            B = len(idxs)
            Bp = bucket_batch(B)
            batch = np.stack([np.asarray(prompts[i], np.int32)
                              for i in idxs] +
                             [np.asarray(prompts[idxs[0]], np.int32)] *
                             (Bp - B))
            got = fetch(self.generate({"tokens": batch}, max_new))
            self._bill(-(Bp - B), 0)
            out[idxs] = got[:B]
        return out

    @property
    def flops_spent(self) -> float:
        return self.tokens_processed * self.cfg.flops_per_token()

    def stats(self) -> dict:
        with self._lock:
            return {"calls": self.calls,
                    "tokens_processed": self.tokens_processed,
                    "flops_spent": self.flops_spent,
                    "jit_variants": len(self._variants),
                    "jit_hits": self.jit_hits,
                    "jit_misses": self.jit_misses}

    def export_counters(self) -> dict:
        with self._lock:
            return {"calls": self.calls,
                    "tokens_processed": self.tokens_processed}

    def restore_counters(self, st: dict) -> None:
        with self._lock:
            self.calls = st["calls"]
            self.tokens_processed = st["tokens_processed"]
