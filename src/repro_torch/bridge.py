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

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig


def _tensor(x, device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":        # ml_dtypes' bf16: copy the bits
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _convert(tree, device):
    if isinstance(tree, dict):
        return {k: _convert(v, device) for k, v in tree.items()}
    return _tensor(tree, device)


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


def _layer_shapes(n, D, H, KV, hd, Fd, norm: bool, gated: bool) -> dict:
    ln = {"scale": (n, D)} if norm else {}
    mlp = {"w_up": (n, D, Fd), "w_down": (n, Fd, D)}
    if gated:
        mlp["w_gate"] = (n, D, Fd)
    return {"ln1": ln, "ln2": dict(ln), "mlp": mlp,
            "attn": {"wq": (n, D, H, hd), "wk": (n, D, KV, hd),
                     "wv": (n, D, KV, hd), "wo": (n, H, hd, D)}}


def lm_params(cfg: ModelConfig, tree: dict, device="cuda") -> dict:
    """A dense LM's JAX parameters (numpy leaves) as the port's."""
    if cfg.family != "dense":
        raise NotImplementedError(f"bridge: family {cfg.family!r}")
    norm = cfg.norm_type != "nonparametric_ln"
    shapes: dict[str, Any] = {
        "embed": (cfg.vocab_size, cfg.d_model),
        "final_norm": {"scale": (cfg.d_model,)} if norm else {},
        "layers": _layer_shapes(cfg.num_layers, cfg.d_model, cfg.num_heads,
                                cfg.num_kv_heads, cfg.head_dim, cfg.d_ff,
                                norm, cfg.gated_mlp),
    }
    if not cfg.tie_embeddings:
        shapes["unembed"] = (cfg.vocab_size, cfg.d_model)
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
