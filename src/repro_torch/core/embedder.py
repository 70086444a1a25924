"""Request embedding encoder (the all-MiniLM-L12-v2 analog): the inference
half of ``src/repro/core/embedder.py``.

A bidirectional transformer over PAD-masked keys, mean-pooled over
non-PAD positions, projected to ``embed_dim`` and L2-normalized. The
attention runs through ``ops.flash_attention`` with a per-row key count:
the callers right-pad prompts to ``seq_len``, so the non-PAD keys of a row
are exactly its first ``kv_len`` positions. A PAD before a non-PAD token
would break that (the JAX encoder masks such a key wherever it sits), so
:func:`embed` refuses it rather than differ silently.
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


def embed(cfg: EmbedderConfig, params: Any, tokens) -> torch.Tensor:
    """tokens (B, S) int, right-padded with PAD -> (B, embed_dim) unit-norm
    f32 on the params' device."""
    host = np.asarray(tokens.cpu() if torch.is_tensor(tokens) else tokens)
    live = host != tk.PAD
    if (live[:, 1:] & ~live[:, :-1]).any():
        raise ValueError("embed: a PAD precedes a non-PAD token; prompts "
                         "must be right-padded")
    dev = params["embed"].device
    toks = torch.as_tensor(host, dtype=torch.int64, device=dev)
    mask = torch.as_tensor(live, device=dev)
    kv_len = mask.sum(dim=1).to(torch.int32)
    B, S = toks.shape
    x = params["embed"][toks] * cfg.d_model ** 0.5
    positions = torch.arange(S, dtype=torch.int32, device=dev)[None].expand(
        B, S)
    for i in range(cfg.num_layers):
        lp = layer_params(params["layers"], i)
        h = L.rmsnorm(lp["ln1"], x)
        q, k, v = L.attention_qkv(lp["attn"], h, positions, cfg.rope_theta)
        attn = ops.flash_attention(q, k, v, causal=False, kv_len=kv_len)
        h = x + L.attention_out(lp["attn"], attn)
        x = h + L.mlp(lp["mlp"], L.rmsnorm(lp["ln2"], h))
    x = L.rmsnorm(params["final_norm"], x)
    w = mask.float()[..., None]
    pooled = (x * w).sum(dim=1) / torch.clamp(w.sum(dim=1), min=1.0)
    out = pooled @ params["proj"]
    return out / torch.clamp(out.norm(dim=-1, keepdim=True), min=1e-9)
