"""Abstract inputs for every (architecture × input shape) pair: the
counterpart of ``src/repro/launch/specs.py``.

Where the JAX package traces with ``jax.eval_shape``, the port builds its
trees under a ``FakeTensorMode``: :func:`init_params`, the optimizer
state and the cache run as they would, but every tensor is a fake with a
shape, a dtype and no storage. ``input_specs`` returns such tensors, all
of one fake mode (``spec["fake_mode"]``, in which a caller goes on), plus
which step the pair runs (``train`` / ``prefill`` / ``decode``).

Modality frontends are stubs per the brief: VLM pairs get precomputed
patch embeddings, audio pairs get precomputed frame embeddings, both at
d_model.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.models import init_cache, init_params
from repro_torch.models.config import ModelConfig
from repro_torch.training.optimizer import init_opt_state
from repro_torch.tree import leaves

INPUT_SHAPES = {
    # name: (seq_len, global_batch, kind)
    "train_4k": (4_096, 256, "train"),
    "prefill_32k": (32_768, 32, "prefill"),
    "decode_32k": (32_768, 128, "decode"),
    "long_500k": (524_288, 1, "decode"),
}

# long_500k policy: sub-quadratic attention required. SSM / hybrid /
# native-sliding-window run as-is; dense/moe/vlm run the sliding-window
# decode variant; whisper (enc-dec, 448-token decoder context by
# construction) is skipped.
LONG_SKIP = {"whisper-medium"}
LONG_DECODE_WINDOW = 4096


def shape_kind(shape_name: str) -> str:
    return INPUT_SHAPES[shape_name][2]


# The reference's budget and data-axis width, kept so that grad_accum
# equals the JAX package's pair for pair (an H100 budget would be another
# result: ROADMAP.md's open questions).
ACT_BUDGET_BYTES = 1e9      # live-activation budget per device
DATA_SHARDS = 16            # single-pod data-axis size (worst case)


def auto_grad_accum(cfg: ModelConfig, global_batch: int, seq: int) -> int:
    """Microbatch count so per-device live activations (one residual
    carry per layer) fit the budget."""
    layers = cfg.num_layers + cfg.encoder_layers
    act_per_row = seq * cfg.d_model * 2 * max(layers, 1)
    if cfg.family == "moe":
        # expert dispatch buffers scale with k: ≈ (1 + k·cf) residual-widths
        act_per_row *= 1 + cfg.experts_per_token
    rows_per_device = max(global_batch // DATA_SHARDS, 1)
    need = act_per_row * rows_per_device / ACT_BUDGET_BYTES
    accum = 1
    while accum < need and accum < global_batch // DATA_SHARDS:
        accum *= 2
    return accum


def supported(cfg: ModelConfig, shape_name: str) -> bool:
    if shape_name == "long_500k" and cfg.name in LONG_SKIP:
        return False
    return True


def config_for_shape(cfg: ModelConfig, shape_name: str) -> ModelConfig:
    """Apply shape-specific config adjustments (the sliding-window decode
    variant for long-context decode on attention archs)."""
    if (shape_name == "long_500k" and cfg.family in
            ("dense", "moe", "vlm", "hybrid")):
        return dataclasses.replace(cfg, decode_window=LONG_DECODE_WINDOW)
    return cfg


def fake_mode():
    """A fresh ``FakeTensorMode``: tensors made under it have no storage."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    return FakeTensorMode()


def param_specs(cfg: ModelConfig, mode=None) -> Any:
    with mode or fake_mode():
        return init_params(cfg, 0, device="cpu")


def opt_specs(params: Any) -> Any:
    """The optimizer state of ``params`` (fakes), in their fake mode."""
    with leaves(params)[0].fake_mode:
        return init_opt_state(params)


def cache_specs(cfg: ModelConfig, batch: int, max_len: int,
                mode=None) -> Any:
    with mode or fake_mode():
        return init_cache(cfg, batch, max_len, torch.bfloat16, device="cpu")


def input_specs(cfg: ModelConfig, shape_name: str) -> dict[str, Any]:
    """Returns {kind, cfg, fake_mode, params, and kind-specific abstract
    inputs}."""
    seq, batch, kind = INPUT_SHAPES[shape_name]
    cfg = config_for_shape(cfg, shape_name)
    mode = fake_mode()
    params = param_specs(cfg, mode)

    def tok(*s):
        with mode:
            return torch.empty(s, dtype=torch.int32)

    def emb(*s):
        with mode:
            return torch.empty(s, dtype=torch.bfloat16)

    out = {"kind": kind, "cfg": cfg, "fake_mode": mode, "params": params}
    if kind == "train":
        data = {"tokens": tok(batch, seq), "labels": tok(batch, seq)}
        if cfg.family == "vlm":
            data["patch_embeds"] = emb(batch, cfg.num_patches, cfg.d_model)
        if cfg.family == "audio":
            data["frames"] = emb(batch, cfg.encoder_frames, cfg.d_model)
        return dict(out, opt_state=opt_specs(params), batch=data,
                    grad_accum=auto_grad_accum(cfg, batch, seq))

    if kind == "prefill":
        data = {"tokens": tok(batch, seq)}
        extra = 0
        if cfg.family == "vlm":
            data["patch_embeds"] = emb(batch, cfg.num_patches, cfg.d_model)
            extra = cfg.num_patches
        if cfg.family == "audio":
            data["frames"] = emb(batch, cfg.encoder_frames, cfg.d_model)
        return dict(out, batch=data, max_len=seq + extra)

    # decode: ONE new token against a cache of seq_len entries
    return dict(out, tokens=tok(batch),
                cache=cache_specs(cfg, batch, seq, mode), pos=tok())
