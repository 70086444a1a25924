"""Decoder model, the counterpart of the dense and moe families of
``src/repro/models/model.py``: ``init_params``, ``embed_tokens``,
``output_logits``, ``forward``, ``loss_fn``, ``init_cache``, ``prefill``,
``_pad_kv`` and ``decode_step``. The moe family swaps each layer's MLP for
:func:`repro_torch.models.layers.moe` and sums its aux loss over the
layers. The ssm, hybrid, vlm and audio families are not ported yet
(:func:`_check_family` refuses them).

Public layouts are the JAX package's: parameters stacked on a leading
layer axis, the KV cache (L, B, M, KV, hd), queries (B, S, H, hd). The
layer scan is a Python loop. Sequence attention goes to
``ops.flash_attention`` (causal, the layer's window) and step attention to
``ops.decode_attention`` with ``cache_len = pos + 1``: one shared position
for the whole batch, so the causal mask over cache slots is exactly a
valid-length mask. Unlike the functional JAX version, :func:`decode_step`
writes the new key/value into the cache in place.

The ring KV cache (``ring_cache`` with ``decode_window`` > 0): the cache
holds ``min(max_len, decode_window)`` slots and a decode step writes slot
``pos % M``, so slot i holds position ``pos - ((pos - i) mod M)`` (not yet
written when negative); the decode kernel reads it in ring mode. As in
JAX, a ring is what :func:`init_cache` and :func:`decode_step` from
position 0 build; :func:`prefill` pads its cache to ``max_len``.

The training forward (:func:`forward`, :func:`loss_fn`) runs the same
blocks with the model-level :func:`repro_torch.models.layers.attention`,
which autograd differentiates; the kernels are forward-only and refuse a
tensor that requires grad.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig, assert_valid

Params = dict[str, Any]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

AUX_LOSS_WEIGHT = 0.01


def param_dtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.param_dtype]


#: the families not ported yet, and the ROADMAP item that ports them
UNPORTED = {"ssm": "ROADMAP.md queue 1 item 3",
            "hybrid": "ROADMAP.md queue 1 item 3",
            "vlm": "ROADMAP.md queue 1 item 4",
            "audio": "ROADMAP.md queue 1 item 4"}


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family in UNPORTED:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported yet "
            f"({UNPORTED[cfg.family]}); the port runs the dense and moe "
            f"families")
    if cfg.family not in ("dense", "moe"):
        raise ValueError(cfg.family)


def _ring(cfg: ModelConfig) -> bool:
    return cfg.ring_cache and cfg.decode_window > 0


def layer_params(params: Params, i: int) -> Params:
    """Layer ``i`` of a stack of parameters (leading layer axis)."""
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i]
            for k, v in params.items()}


# ===========================================================================
# Parameter initialization
# ===========================================================================


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> Params:
    """Random weights from ``torch.Generator(seed)``, with the JAX
    package's distributions: fan-in normal projections, unit-normal
    embedding, zero norm scales; the moe family's layers hold ``moe``
    (:func:`layers.moe_init`) in place of ``mlp``. Layers are filled one
    at a time, so the f32 scratch stays one layer's size."""
    assert_valid(cfg)
    _check_family(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dt = param_dtype(cfg)
    D, H, KV, hd, Fd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                        cfg.head_dim, cfg.d_ff)
    n = cfg.num_layers

    def stack(shape, in_axis=0):
        out = torch.empty((n,) + shape, dtype=dt, device=dev)
        for i in range(n):
            out[i] = L.dense_init(gen, shape, in_axis, dt, dev)
        return out

    def norm():
        return ({} if cfg.norm_type == "nonparametric_ln" else
                {"scale": torch.zeros((n, D), dtype=torch.float32,
                                      device=dev)})

    if cfg.family == "moe":
        ffn = {}
        for i in range(n):
            for k, v in L.moe_init(gen, D, Fd, cfg.num_experts, dt,
                                   dev).items():
                if k not in ffn:
                    ffn[k] = torch.empty((n,) + v.shape, dtype=v.dtype,
                                         device=dev)
                ffn[k][i] = v
    else:
        ffn = {"w_up": stack((D, Fd)), "w_down": stack((Fd, D))}
        if cfg.gated_mlp:
            ffn["w_gate"] = stack((D, Fd))
    params: Params = {
        "embed": L.normal(gen, (cfg.vocab_size, D), 1.0, dt, dev),
        "final_norm": ({} if cfg.norm_type == "nonparametric_ln" else
                       {"scale": torch.zeros((D,), dtype=torch.float32,
                                             device=dev)}),
        "layers": {
            "ln1": norm(),
            "attn": {"wq": stack((D, H, hd)), "wk": stack((D, KV, hd)),
                     "wv": stack((D, KV, hd)),
                     "wo": stack((H, hd, D), in_axis=1)},
            "ln2": norm(),
            "moe" if cfg.family == "moe" else "mlp": ffn,
        },
    }
    if not cfg.tie_embeddings:
        params["unembed"] = L.dense_init(gen, (cfg.vocab_size, D), 1, dt,
                                         dev)
    return params


# ===========================================================================
# Embedding & head
# ===========================================================================


def embed_tokens(cfg: ModelConfig, params: Params, tokens: torch.Tensor):
    dt = param_dtype(cfg)
    x = params["embed"][tokens].to(dt)
    return x * torch.tensor(cfg.d_model ** 0.5, dtype=dt, device=x.device)


def output_logits(cfg: ModelConfig, params: Params, x: torch.Tensor):
    x = L.apply_norm(cfg.norm_type, params.get("final_norm"), x)
    w = params["embed"] if cfg.tie_embeddings else params["unembed"]
    return L.unembed(w, x)


# ===========================================================================
# Blocks
# ===========================================================================


def kernel_attention(q, k, v, positions, window: int, causal: bool):
    """Sequence attention for serving: the flash kernel (positions are the
    sequence's own, aligned to its end)."""
    return ops.flash_attention(q, k, v, causal=causal, window=window)


def model_attention(q, k, v, positions, window: int, causal: bool):
    """Sequence attention for training: differentiable
    :func:`layers.attention`."""
    return L.attention(q, k, v, q_positions=positions, k_positions=positions,
                       causal=causal, window=window)


def _ffn(cfg: ModelConfig, lp: Params, h):
    """The layer's MLP, or its MoE: (output, aux loss or None)."""
    if "moe" in lp:
        return L.moe(lp["moe"], h, experts_per_token=cfg.experts_per_token,
                     capacity_factor=cfg.moe_capacity_factor,
                     dispatch=cfg.moe_dispatch)
    return L.mlp(lp["mlp"], h), None


def _attn_block_seq(cfg: ModelConfig, lp: Params, x, positions,
                    window: int, *, causal: bool, attend=kernel_attention):
    """Attention + FFN residual block over a whole sequence; returns the
    new hidden state, this layer's (k, v) and its aux loss (None without
    a MoE)."""
    h = L.apply_norm(cfg.norm_type, lp.get("ln1"), x)
    q, k, v = L.attention_qkv(lp["attn"], h, positions, cfg.rope_theta)
    attn = attend(q, k, v, positions, window, causal)
    x = x + L.attention_out(lp["attn"], attn)
    h = L.apply_norm(cfg.norm_type, lp.get("ln2"), x)
    f, aux = _ffn(cfg, lp, h)
    return x + f, k, v, aux


def _attn_block_step(cfg: ModelConfig, lp: Params, x_t, pos: int,
                     cache_len: torch.Tensor, window: int, ck, cv):
    """One-token decode: write k/v at ``pos`` of this layer's cache (slot
    ``pos % M`` of a ring; in place), attend over the cache."""
    B = x_t.shape[0]
    ring = _ring(cfg)
    h = L.apply_norm(cfg.norm_type, lp.get("ln1"), x_t[:, None, :])
    qpos = torch.full((B, 1), pos, dtype=torch.int32, device=x_t.device)
    q, k, v = L.attention_qkv(lp["attn"], h, qpos, cfg.rope_theta)
    slot = pos % ck.shape[1] if ring else pos
    ck[:, slot] = k[:, 0]
    cv[:, slot] = v[:, 0]
    w = window
    if cfg.decode_window > 0 and window <= 0:
        w = cfg.decode_window
    attn = ops.decode_attention(q[:, 0], ck, cv, cache_len, window=w,
                                ring=ring)
    x_t = x_t + L.attention_out(lp["attn"], attn[:, None])[:, 0]
    h = L.apply_norm(cfg.norm_type, lp.get("ln2"), x_t[:, None, :])
    return x_t + _ffn(cfg, lp, h)[0][:, 0]


# ===========================================================================
# Full-sequence forward (training)
# ===========================================================================


def _positions(tokens: torch.Tensor) -> torch.Tensor:
    B, S = tokens.shape
    return torch.arange(S, dtype=torch.int32,
                        device=tokens.device)[None].expand(B, S)


def forward(cfg: ModelConfig, params: Params, batch: dict):
    """Teacher-forcing forward of ``batch["tokens"]`` (B, S): (logits
    (B, S, V) f32, the aux loss summed over the layers: 0 for the dense
    family)."""
    _check_family(cfg)
    tokens = batch["tokens"]
    x = embed_tokens(cfg, params, tokens)
    positions = _positions(tokens)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, window in enumerate(cfg.layer_windows()):
        x, _, _, aux = _attn_block_seq(cfg, layer_params(params["layers"], i),
                                       x, positions, window, causal=True,
                                       attend=model_attention)
        if aux is not None:
            total = total + aux
    return output_logits(cfg, params, x), total


def loss_fn(cfg: ModelConfig, params: Params, batch: dict):
    """Masked next-token cross-entropy (labels < 0 are ignored) plus the
    weighted aux loss; metrics ``ce``, ``aux`` and ``accuracy``."""
    logits, aux = forward(cfg, params, batch)
    labels = batch["labels"].long()
    mask = (labels >= 0).float()
    safe = labels.clamp(min=0)
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, safe[..., None])[..., 0]
    denom = torch.clamp(mask.sum(), min=1.0)
    ce = (nll * mask).sum() / denom
    hits = (torch.argmax(logits, dim=-1) == labels).float()
    return ce + AUX_LOSS_WEIGHT * aux, {
        "ce": ce, "aux": aux, "accuracy": (hits * mask).sum() / denom}


# ===========================================================================
# KV cache, prefill, decode
# ===========================================================================


def init_cache(cfg: ModelConfig, batch_size: int, max_len: int,
               dtype=None, device="cuda") -> Params:
    """Zero cache {"k", "v"}: (L, B, M, KV, hd) each, M = max_len, or
    ``min(max_len, decode_window)`` slots for a ring."""
    _check_family(cfg)
    dev = resolve_device(device)
    M = min(max_len, cfg.decode_window) if _ring(cfg) else max_len
    shape = (cfg.num_layers, batch_size, M, cfg.num_kv_heads, cfg.head_dim)
    dt = dtype or param_dtype(cfg)
    return {"k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev)}


def _pad_kv(kv: Params, max_len: int) -> Params:
    """(L, B, S, KV, hd) -> (L, B, max_len, KV, hd), zero slots after S."""
    S = kv["k"].shape[2]
    if max_len < S:
        raise ValueError(f"cache of {max_len} slots cannot hold {S}")
    pad = (0, 0, 0, 0, 0, max_len - S)
    return {"k": torch.nn.functional.pad(kv["k"], pad),
            "v": torch.nn.functional.pad(kv["v"], pad)}


def prefill(cfg: ModelConfig, params: Params, batch: dict, max_len: int):
    """Run the prompt ``batch["tokens"]`` (B, S) through the model.
    Returns (last-position logits (B, V) f32, cache, next position)."""
    _check_family(cfg)
    tokens = batch["tokens"]
    x = embed_tokens(cfg, params, tokens)
    S = tokens.shape[1]
    positions = _positions(tokens)
    ks, vs = [], []
    for i, window in enumerate(cfg.layer_windows()):
        x, k, v, _ = _attn_block_seq(cfg, layer_params(params["layers"], i),
                                     x, positions, window, causal=True)
        ks.append(k)
        vs.append(v)
    cache = _pad_kv({"k": torch.stack(ks), "v": torch.stack(vs)}, max_len)
    logits = output_logits(cfg, params, x[:, -1:, :])[:, 0]
    return logits, cache, S


def decode_step(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                cache: Params, pos: int):
    """One decode step: ``tokens`` (B,) sit at position ``pos`` (the cache
    holds positions [0, pos), or a ring their last M). Returns (logits
    (B, V), cache), the cache updated in place."""
    _check_family(cfg)
    x = embed_tokens(cfg, params, tokens[:, None])[:, 0]
    B = x.shape[0]
    cache_len = torch.full((B,), pos + 1, dtype=torch.int32,
                           device=x.device)
    for i, window in enumerate(cfg.layer_windows()):
        x = _attn_block_step(cfg, layer_params(params["layers"], i), x, pos,
                             cache_len, window, cache["k"][i],
                             cache["v"][i])
    return output_logits(cfg, params, x[:, None, :])[:, 0], cache
