"""Carry the JAX package's parameters into the port.

The port keeps the JAX parameter trees as they are (nested dicts, layer
parameters stacked on a leading axis by ``jax.vmap``, attention
projections with an explicit head axis), so the bridge is a checked copy:
every leaf becomes a tensor on ``device`` and the tree is held to the
config's shapes. It takes the tree with numpy leaves (a caller with JAX
maps ``np.asarray`` over it first) and imports nothing of JAX.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.configs import rar_system
from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.tree import tree_map


def _tensor(x, device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":        # ml_dtypes' bf16: copy the bits
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _convert(tree, device):
    return tree_map(lambda x: _tensor(x, device), tree)


def _check(tree, shapes, path="") -> None:
    if set(tree) != set(shapes):
        raise ValueError(f"parameter tree{path}: keys {sorted(tree)} != "
                         f"{sorted(shapes)}")
    for k, want in shapes.items():
        if isinstance(want, dict):
            _check(tree[k], want, f"{path}.{k}")
        elif tuple(tree[k].shape) != want:
            raise ValueError(f"parameter {path}.{k}: shape "
                             f"{tuple(tree[k].shape)} != {want}")


def _layer_shapes(n, D, H, KV, hd, Fd, norm: bool, gated: bool,
                  experts: int = 0) -> dict:
    """A stack of n attention layers; with ``experts`` > 0 their FFN is a
    MoE (``moe``: the f32 router and the experts' weights) in place of
    the MLP."""
    ln = {"scale": (n, D)} if norm else {}
    if experts:
        ffn = {"moe": {"router": (n, D, experts),
                       "w_gate": (n, experts, D, Fd),
                       "w_up": (n, experts, D, Fd),
                       "w_down": (n, experts, Fd, D)}}
    else:
        mlp = {"w_up": (n, D, Fd), "w_down": (n, Fd, D)}
        if gated:
            mlp["w_gate"] = (n, D, Fd)
        ffn = {"mlp": mlp}
    return {"ln1": ln, "ln2": dict(ln), **ffn,
            "attn": {"wq": (n, D, H, hd), "wk": (n, D, KV, hd),
                     "wv": (n, D, KV, hd), "wo": (n, H, hd, D)}}


def _ssm_shapes(cfg: ModelConfig, norm: bool) -> dict:
    """A stack of Mamba-2 layers (``ssm.mamba2_init`` per layer)."""
    n, D, di = cfg.num_layers, cfg.d_model, cfg.d_inner
    GN, H = cfg.ssm_groups * cfg.ssm_state, cfg.ssm_heads
    C = di + 2 * GN
    return {"ln1": {"scale": (n, D)} if norm else {},
            "mixer": {"in_proj": (n, D, 2 * di + 2 * GN + H),
                      "conv": {"w": (n, cfg.d_conv, C), "b": (n, C)},
                      "A_log": (n, H), "D": (n, H), "dt_bias": (n, H),
                      "norm": {"scale": (n, di)},
                      "out_proj": (n, di, D)}}


def _rglru_shapes(cfg: ModelConfig, n: int, norm: bool) -> dict:
    """A stack of n RG-LRU layers: the recurrent block and a dense MLP."""
    D, R, Fd = cfg.d_model, cfg.d_rnn, cfg.d_ff
    ln = {"scale": (n, D)} if norm else {}
    mlp = {"w_up": (n, D, Fd), "w_down": (n, Fd, D)}
    if cfg.gated_mlp:
        mlp["w_gate"] = (n, D, Fd)
    return {"ln1": ln, "ln2": dict(ln), "mlp": mlp,
            "rglru": {"w_gate_branch": (n, D, R), "w_rnn_branch": (n, D, R),
                      "conv": {"w": (n, cfg.d_conv, R), "b": (n, R)},
                      "w_a": (n, R, R), "w_i": (n, R, R), "b_a": (n, R),
                      "b_i": (n, R), "lambda": (n, R),
                      "out_proj": (n, R, D)}}


def lm_params(cfg: ModelConfig, tree: dict, device="cuda") -> dict:
    """An LM's JAX parameters (numpy leaves) as the port's, for every
    family of the zoo, its head tied to the embedding or its own
    ``unembed``."""
    norm = cfg.norm_type != "nonparametric_ln"
    D = cfg.d_model

    def attn_layers(n, experts=0):
        return _layer_shapes(n, D, cfg.num_heads, cfg.num_kv_heads,
                             cfg.head_dim, cfg.d_ff, norm, cfg.gated_mlp,
                             experts)
    shapes: dict[str, Any] = {
        "embed": (cfg.vocab_size, D),
        "final_norm": {"scale": (D,)} if norm else {},
    }
    if cfg.family in ("dense", "moe", "vlm", "audio"):
        shapes["layers"] = attn_layers(
            cfg.num_layers, cfg.num_experts if cfg.family == "moe" else 0)
    if cfg.family == "audio":
        n, hd = cfg.num_layers, cfg.head_dim
        shapes["layers"]["ln_cross"] = {"scale": (n, D)} if norm else {}
        shapes["layers"]["cross_attn"] = {
            "wq": (n, D, cfg.num_heads, hd), "wk": (n, D, cfg.num_kv_heads, hd),
            "wv": (n, D, cfg.num_kv_heads, hd),
            "wo": (n, cfg.num_heads, hd, D)}
        shapes["enc_layers"] = attn_layers(cfg.encoder_layers)
        shapes["enc_norm"] = {"scale": (D,)} if norm else {}
    elif cfg.family == "ssm":
        shapes["layers"] = _ssm_shapes(cfg, norm)
    elif cfg.family == "hybrid":
        blocks = cfg.layer_blocks()
        shapes["attn_layers"] = attn_layers(blocks.count("a"))
        shapes["rglru_layers"] = _rglru_shapes(cfg, blocks.count("r"), norm)
    elif cfg.family not in ("dense", "moe", "vlm"):
        raise ValueError(f"bridge: family {cfg.family!r}")
    if not cfg.tie_embeddings:
        shapes["unembed"] = (cfg.vocab_size, D)
    _check(tree, shapes)
    return _convert(tree, resolve_device(device))


def embedder_params(cfg, tree: dict, device="cuda") -> dict:
    """The JAX encoder's parameters (numpy leaves) as the port's;
    ``cfg`` is an ``EmbedderConfig``."""
    D = cfg.d_model
    shapes = {
        "embed": (cfg.vocab_size, D),
        "layers": _layer_shapes(cfg.num_layers, D, cfg.num_heads,
                                cfg.num_heads, cfg.head_dim, cfg.d_ff,
                                True, True),
        "final_norm": {"scale": (D,)},
        "proj": (D, cfg.embed_dim),
    }
    _check(tree, shapes)
    return _convert(tree, resolve_device(device))


def router(w, b, embed_dim: int, device="cuda") -> tuple:
    """The JAX ``LearnedRouter``'s (w (E,), b ()) as tensors."""
    _check({"w": w, "b": b}, {"w": (embed_dim,), "b": ()})
    dev = resolve_device(device)
    return _tensor(w, dev), _tensor(b, dev)


def system(blob: dict, device="cuda") -> dict:
    """The JAX package's trained system — the tree its
    ``experiments/setup.py`` caches, ``{"weak", "strong", "embedder",
    "router_w", "router_b"}`` with numpy leaves — as the parameters
    ``repro_torch.experiments.setup.build_system(params=...)`` takes."""
    w, b = router(blob["router_w"], blob["router_b"],
                  rar_system.EMBEDDER.embed_dim, device)
    return {"weak": lm_params(rar_system.WEAK, blob["weak"], device),
            "strong": lm_params(rar_system.STRONG, blob["strong"], device),
            "embedder": embedder_params(rar_system.EMBEDDER,
                                        blob["embedder"], device),
            "router_w": w, "router_b": b}
