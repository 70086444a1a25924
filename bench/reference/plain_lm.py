"""Plain float32 transformers: the decoder LMs (dense or top-k MoE with
per-row expert capacity) and the bidirectional request embedder, written
from their equations with plain PyTorch products.

Parameter trees are nested dicts of tensors with the stacked layout the
benchmark hands to both sides: attention projections with an explicit
head axis (``wq`` (L, D, H, hd), ``wo`` (L, H, hd, D)), MLP or MoE weights
per layer, zero-centred RMSNorm scales. ``cast`` rounds the operands of
every product (:mod:`bench.reference.numerics`); float32 is the reference,
a lower precision its control.

Semantics kept on purpose, each as the measured system states it:
RoPE on the first/second half split of each head; causal attention over
the prompt; the MoE router in float32, its top k by a stable descending
sort (ties to the lower expert), the k gates renormalised, each (token,
slot) taking the next place of its expert in the row in (position, slot)
order and dropped past ``max(1, int(cf * k * S / E))`` places.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from bench.reference.numerics import f32, mm


def rmsnorm(x: torch.Tensor, scale, eps: float = 1e-6) -> torch.Tensor:
    x = x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps)
    return x if scale is None else x * (1.0 + scale.float())


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, H, hd) at positions 0..S-1."""
    S, hd = x.shape[1], x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                          device=x.device) / hd))
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v, *, causal: bool, live=None, cast=f32,
              q_block: int = 1024) -> torch.Tensor:
    """q (B, S, H, hd), k/v (B, S, KV, hd) -> (B, S, H, hd), a whole
    softmax per query row; ``live`` (B, S) bool masks keys."""
    B, S, H, hd = q.shape
    G = H // k.shape[2]
    k = k.repeat_interleave(G, dim=2).transpose(1, 2)      # (B, H, S, hd)
    v = v.repeat_interleave(G, dim=2).transpose(1, 2)
    q = q.transpose(1, 2) * hd ** -0.5
    out = torch.empty_like(q)
    kpos = torch.arange(S, device=q.device)
    for s0 in range(0, S, q_block):
        s1 = min(S, s0 + q_block)
        scores = mm(q[:, :, s0:s1], k.transpose(-1, -2), cast)
        mask = torch.ones((s1 - s0, S), dtype=torch.bool, device=q.device)
        if causal:
            mask = kpos[None, :] <= torch.arange(s0, s1, device=q.device)[:, None]
        mask = mask[None, None]
        if live is not None:
            mask = mask & live[:, None, None, :]
        scores = scores.masked_fill(~mask, float("-inf"))
        out[:, :, s0:s1] = mm(torch.softmax(scores, dim=-1), v, cast)
    return out.transpose(1, 2)


def _proj(x, w, cast):
    """x (B, S, D) @ w (D, H, hd) -> (B, S, H, hd)."""
    D, H, hd = w.shape
    return mm(x, w.reshape(D, H * hd), cast).view(*x.shape[:2], H, hd)


def _attn_block(lp, x, theta, *, causal, live, cast):
    h = rmsnorm(x, lp.get("ln1", {}).get("scale"))
    q = rope(_proj(h, lp["attn"]["wq"], cast), theta)
    k = rope(_proj(h, lp["attn"]["wk"], cast), theta)
    v = _proj(h, lp["attn"]["wv"], cast)
    a = attention(q, k, v, causal=causal, live=live, cast=cast)
    wo = lp["attn"]["wo"]
    return x + mm(a.reshape(*a.shape[:2], -1), wo.reshape(-1, wo.shape[-1]),
                  cast)


def mlp(p, h, cast):
    up = mm(h, p["w_up"], cast)
    return mm(F.silu(mm(h, p["w_gate"], cast)) * up, p["w_down"], cast)


def moe(p, h, *, k: int, capacity_factor: float, cast):
    """Top-k MoE over h (B, S, D), per-row capacity; float32 throughout."""
    B, S, D = h.shape
    E = p["router"].shape[-1]
    probs = torch.softmax(mm(h, p["router"], cast), dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    vals, idx = vals[..., :k], idx[..., :k]
    gates = vals / vals.sum(-1, keepdim=True).clamp(min=1e-9)
    capacity = max(1, int(capacity_factor * k * S / E))
    flat = idx.reshape(B, S * k)
    onehot = F.one_hot(flat, E)
    pos = ((onehot.cumsum(1) - onehot) * onehot).sum(-1)     # (B, S*k)
    keep = (pos < capacity).reshape(-1)
    flat, gflat = flat.reshape(-1), gates.reshape(-1)
    rows = torch.arange(B * S * k, device=h.device) // k       # token rows
    hf = h.reshape(B * S, D)
    out = torch.zeros_like(hf)
    for e in range(E):
        sel = torch.nonzero((flat == e) & keep).squeeze(1)
        if sel.numel() == 0:
            continue
        xe = hf[rows[sel]]
        ye = mm(F.silu(mm(xe, p["w_gate"][e], cast)) *
                mm(xe, p["w_up"][e], cast), p["w_down"][e], cast)
        out.index_add_(0, rows[sel], ye * gflat[sel, None])
    return out.view(B, S, D)


def layer(params, i: int):
    return {key: layer(v, i) if isinstance(v, dict) else v[i]
            for key, v in params.items()}


def lm_last_logits(cfg: dict, params: dict, tokens: torch.Tensor,
                   cast=f32) -> torch.Tensor:
    """Logits (B, V) of the next token after each whole row of ``tokens``
    (B, S); ``cfg`` holds ``num_layers``, ``d_model``, ``rope_theta``,
    ``tie_embeddings`` and, for a MoE, ``experts_per_token`` and
    ``moe_capacity_factor``."""
    x = params["embed"][tokens.long()].float() * cfg["d_model"] ** 0.5
    for i in range(cfg["num_layers"]):
        lp = layer(params["layers"], i)
        x = _attn_block(lp, x, cfg["rope_theta"], causal=True, live=None,
                        cast=cast)
        h = rmsnorm(x, lp.get("ln2", {}).get("scale"))
        if "moe" in lp:
            x = x + moe(lp["moe"], h, k=cfg["experts_per_token"],
                        capacity_factor=cfg["moe_capacity_factor"],
                        cast=cast)
        else:
            x = x + mlp(lp["mlp"], h, cast)
    x = rmsnorm(x[:, -1], params.get("final_norm", {}).get("scale"))
    head = params["embed"] if cfg.get("tie_embeddings") else params["unembed"]
    return mm(x, head.T, cast)


def embed(cfg: dict, params: dict, tokens: torch.Tensor, pad: int = 0,
          cast=f32) -> torch.Tensor:
    """The request embedder: (B, S) right-padded ids -> (B, E) unit
    vectors. Bidirectional attention over the non-PAD keys, RMSNorm,
    mean over the non-PAD positions, a projection, L2 normalisation."""
    live = tokens != pad
    x = params["embed"][tokens.long()].float() * cfg["d_model"] ** 0.5
    for i in range(cfg["num_layers"]):
        lp = layer(params["layers"], i)
        h = _attn_block(lp, x, cfg["rope_theta"], causal=False, live=live,
                        cast=cast)
        x = h + mlp(lp["mlp"], rmsnorm(h, lp["ln2"]["scale"]), cast)
    x = rmsnorm(x, params["final_norm"]["scale"])
    w = live.float()[..., None]
    pooled = (x * w).sum(dim=1) / w.sum(dim=1).clamp(min=1.0)
    out = mm(pooled, params["proj"], cast)
    return out / out.norm(dim=-1, keepdim=True).clamp(min=1e-9)
