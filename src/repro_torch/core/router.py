"""Static predictive routing (section III-C), the counterpart of
``src/repro/core/router.py``: the RouteLLM-style front gate.

* :class:`LearnedRouter` — logistic regression over request embeddings,
  trained on profiling data (weak-FM success labels).
* :class:`OracleRouter` — the paper's "ideal static router" baseline: the
  eval set is profiled with the weak FM beforehand, and exactly the
  samples the weak FM answered unaided are routed weak.

Both return True = route to the WEAK model.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.training.train_step import value_and_grad


@dataclasses.dataclass
class LearnedRouter:
    w: torch.Tensor       # (E,)
    b: torch.Tensor       # ()
    threshold: float = 0.5

    def prob_weak_ok(self, emb) -> torch.Tensor:
        e = torch.as_tensor(np.asarray(emb, np.float32), device=self.w.device)
        return torch.sigmoid(e @ self.w + self.b)

    def route_weak(self, emb) -> bool:
        return bool(self.prob_weak_ok(emb) >= self.threshold)


def train_router(embs: np.ndarray, success: np.ndarray, *,
                 steps: int = 500, lr: float = 0.5, threshold: float = 0.5,
                 device="cuda") -> LearnedRouter:
    """Logistic regression by full-batch gradient descent, with the JAX
    package's numerically stable BCE on logits."""
    dev = resolve_device(device)
    X = torch.as_tensor(np.asarray(embs, np.float32), device=dev)
    y = torch.as_tensor(np.asarray(success, np.float32), device=dev)

    def loss(params):
        w, b = params["w"], params["b"]
        logits = X @ w + b
        # maximum (not clamp): an exact 0 logit takes half the gradient,
        # as jnp.maximum gives it
        return torch.mean(torch.maximum(logits, torch.zeros_like(logits)) -
                          logits * y +
                          torch.log1p(torch.exp(-torch.abs(logits)))), {}

    params = {"w": torch.zeros((X.shape[1],), dtype=torch.float32,
                               device=dev),
              "b": torch.zeros((), dtype=torch.float32, device=dev)}
    for _ in range(steps):
        _, g = value_and_grad(loss, params)
        params = {k: params[k] - lr * g[k] for k in params}
    return LearnedRouter(w=params["w"], b=params["b"], threshold=threshold)


@dataclasses.dataclass
class OracleRouter:
    """Profiled on the eval set: routes weak iff the weak FM answered this
    exact sample unaided during profiling (paper section IV-B1)."""
    weak_ok_keys: set

    def route_weak_key(self, key) -> bool:
        return key in self.weak_ok_keys
