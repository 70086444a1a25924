"""Request embedding encoder (the all-MiniLM-L12-v2 analog): the
counterpart of ``src/repro/core/embedder.py``.

A bidirectional transformer over PAD-masked keys, mean-pooled over
non-PAD positions, projected to ``embed_dim`` and L2-normalized, trained
with an NT-Xent contrastive objective where questions sharing a latent
skill are positives.

:func:`embed` takes its attention as a parameter. For inference,
:func:`kernel_attention` runs ``ops.flash_attention`` with a per-row key
count: the callers right-pad prompts to ``seq_len``, so the non-PAD keys
of a row are exactly its first ``kv_len`` positions. A PAD before a
non-PAD token would break that (the JAX encoder masks such a key wherever
it sits), so :func:`embed` refuses it rather than differ silently. For
training, :func:`model_attention` is the differentiable
``layers.attention`` with PAD keys at position -10,000,000, as the JAX
encoder masks them.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.data import tokenizer as tk
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.model import layer_params
from repro_torch.training.train_step import value_and_grad
from repro_torch.tree import tree_map


@dataclasses.dataclass(frozen=True)
class EmbedderConfig:
    vocab_size: int = 128
    d_model: int = 128
    num_layers: int = 4
    num_heads: int = 4
    d_ff: int = 256
    embed_dim: int = 384
    rope_theta: float = 10_000.0

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads


def init_params(cfg: EmbedderConfig, seed: int = 0, device="cuda") -> Any:
    """Random f32 weights from ``torch.Generator(seed)`` with the JAX
    encoder's distributions and parameter tree."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    f32 = torch.float32
    D, H, hd, Fd, n = (cfg.d_model, cfg.num_heads, cfg.head_dim, cfg.d_ff,
                       cfg.num_layers)

    def stack(shape, in_axis=0):
        return torch.stack([L.dense_init(gen, shape, in_axis, f32, dev)
                            for _ in range(n)])

    def norm():
        return {"scale": torch.zeros((n, D), dtype=f32, device=dev)}

    return {
        "embed": L.normal(gen, (cfg.vocab_size, D), 1.0, f32, dev),
        "layers": {
            "ln1": norm(),
            "attn": {"wq": stack((D, H, hd)), "wk": stack((D, H, hd)),
                     "wv": stack((D, H, hd)),
                     "wo": stack((H, hd, D), in_axis=1)},
            "ln2": norm(),
            "mlp": {"w_up": stack((D, Fd)), "w_down": stack((Fd, D)),
                    "w_gate": stack((D, Fd))},
        },
        "final_norm": {"scale": torch.zeros((D,), dtype=f32, device=dev)},
        "proj": L.dense_init(gen, (D, cfg.embed_dim), 0, f32, dev),
    }


def kernel_attention(q, k, v, positions, live):
    """Inference: the flash kernel over each row's first ``kv_len``
    (non-PAD) keys."""
    return ops.flash_attention(q, k, v, causal=False,
                               kv_len=live.sum(dim=1).to(torch.int32))


def model_attention(q, k, v, positions, live):
    """Training: differentiable ``layers.attention``, PAD keys masked by a
    negative position."""
    kpos = torch.where(live, positions, -10_000_000)
    return L.attention(q, k, v, q_positions=positions, k_positions=kpos,
                       causal=False, window=0)


def embed(cfg: EmbedderConfig, params: Any, tokens,
          attention=kernel_attention) -> torch.Tensor:
    """tokens (B, S) int, right-padded with PAD -> (B, embed_dim) unit-norm
    f32 on the params' device. ``attention(q, k, v, positions, live)`` is
    :func:`kernel_attention` or :func:`model_attention`."""
    host = np.asarray(tokens.cpu() if torch.is_tensor(tokens) else tokens)
    live = host != tk.PAD
    if (live[:, 1:] & ~live[:, :-1]).any():
        raise ValueError("embed: a PAD precedes a non-PAD token; prompts "
                         "must be right-padded")
    dev = params["embed"].device
    toks = torch.as_tensor(host, dtype=torch.int64, device=dev)
    mask = torch.as_tensor(live, device=dev)
    B, S = toks.shape
    x = params["embed"][toks] * cfg.d_model ** 0.5
    positions = torch.arange(S, dtype=torch.int32, device=dev)[None].expand(
        B, S)
    for i in range(cfg.num_layers):
        lp = layer_params(params["layers"], i)
        h = L.rmsnorm(lp["ln1"], x)
        q, k, v = L.attention_qkv(lp["attn"], h, positions, cfg.rope_theta)
        attn = attention(q, k, v, positions, mask)
        h = x + L.attention_out(lp["attn"], attn)
        x = h + L.mlp(lp["mlp"], L.rmsnorm(lp["ln2"], h))
    x = L.rmsnorm(params["final_norm"], x)
    w = mask.float()[..., None]
    pooled = (x * w).sum(dim=1) / torch.clamp(w.sum(dim=1), min=1.0)
    out = pooled @ params["proj"]
    return out / torch.clamp(out.norm(dim=-1, keepdim=True), min=1e-9)


# ---------------------------------------------------------------------------
# Contrastive training
# ---------------------------------------------------------------------------


def nt_xent_loss(cfg: EmbedderConfig, params: Any, tokens, skill_ids,
                 temperature: float = 0.1) -> torch.Tensor:
    """NT-Xent with same-skill positives (multi-positive InfoNCE)."""
    z = embed(cfg, params, tokens, attention=model_attention)
    sids = torch.as_tensor(np.asarray(skill_ids), device=z.device)
    sim = z @ z.T / temperature
    eye = torch.eye(z.shape[0], dtype=torch.bool, device=z.device)
    pos = (sids[:, None] == sids[None, :]) & ~eye
    sim = torch.where(eye, -1e9, sim)
    logp = torch.log_softmax(sim, dim=-1)
    pos_f = pos.float()
    per_anchor = (logp * pos_f).sum(dim=-1) / torch.clamp(
        pos_f.sum(dim=-1), min=1.0)
    return -per_anchor.mean()


def make_train_step(cfg: EmbedderConfig, lr: float = 3e-4):
    """step(params, opt, tokens, skill_ids) -> (params, opt, loss): one
    NT-Xent gradient and a simple Adam update (no clipping, no decay)."""
    b1, b2, eps = 0.9, 0.999, 1e-8

    def loss(params, tokens, skill_ids):
        return nt_xent_loss(cfg, params, tokens, skill_ids), {}

    def step(params, opt, tokens, skill_ids):
        (value, _), grads = value_and_grad(loss, params, tokens, skill_ids)
        with torch.no_grad():
            t = opt["t"] + 1
            bc1 = 1 - b1 ** t.float()
            bc2 = 1 - b2 ** t.float()
            mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g, opt["mu"],
                          grads)
            nu = tree_map(lambda v, g: b2 * v + (1 - b2) * g * g, opt["nu"],
                          grads)
            params = tree_map(
                lambda p, m, v: p - lr * (m / bc1) /
                (torch.sqrt(v / bc2) + eps), params, mu, nu)
        return params, {"t": t, "mu": mu, "nu": nu}, value

    return step


def init_opt(params: Any) -> dict:
    dev = params["embed"].device
    return {"t": torch.zeros((), dtype=torch.int32, device=dev),
            "mu": tree_map(torch.zeros_like, params),
            "nu": tree_map(torch.zeros_like, params)}
