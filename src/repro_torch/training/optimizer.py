"""AdamW with f32 master weights: the counterpart of
``src/repro/training/optimizer.py``.

The state is nested dicts of tensors on the parameters' device: the step
(int32), f32 ``master`` weights and f32 moments ``mu``/``nu``. The update
clips by the global norm of the gradients, applies decoupled weight decay
to the master and casts the result back to the parameters' dtype. The
arithmetic follows the JAX package operation for operation, in f32, so the
two agree to rounding.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.tree import leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    learning_rate: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def lr_schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup then cosine decay to ``min_lr_ratio``; ``step`` an
    int or an integer tensor, the result an f32 tensor on its device."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = cfg.learning_rate * step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps) /
                       max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return torch.where(step < cfg.warmup_steps, warm,
                       cfg.learning_rate * cos)


def init_opt_state(params: Any) -> dict:
    first = leaves(params)[0]
    return {
        "step": torch.zeros((), dtype=torch.int32, device=first.device),
        "master": tree_map(lambda p: p.detach().to(torch.float32,
                                                   copy=True), params),
        "mu": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device), params),
        "nu": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device), params),
    }


def global_norm(tree: Any) -> torch.Tensor:
    sq = [torch.sum(torch.square(x.to(torch.float32))) for x in leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sq)))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads: Any, opt_state: dict,
                 like: Any = None) -> tuple[Any, dict, dict]:
    """Returns (new params cast to the dtype of ``like`` — or of the
    grads when ``like`` is None — plus new opt state and metrics)."""
    step = opt_state["step"] + 1
    lr = lr_schedule(cfg, step)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = 1 - b1 ** step.to(torch.float32)
    bc2 = 1 - b2 ** step.to(torch.float32)

    def upd(g, m, v, p):
        g = g.to(torch.float32) * scale
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * torch.square(g)
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps) + \
            cfg.weight_decay * p
        return m, v, p - lr * delta

    out = tree_map(upd, grads, opt_state["mu"], opt_state["nu"],
                   opt_state["master"])
    new_mu, new_nu, new_master = (tree_map(lambda o, i=i: o[i], out)
                                  for i in range(3))
    ref = like if like is not None else grads
    cast = tree_map(lambda mp, old: mp.to(old.dtype), new_master, ref)
    new_state = {"step": step, "master": new_master, "mu": new_mu,
                 "nu": new_nu}
    return cast, new_state, {"lr": lr, "grad_norm": gnorm}
