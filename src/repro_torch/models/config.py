"""Architecture configuration.

One frozen dataclass covers all six assigned families
(dense / moe / ssm / hybrid / vlm / audio). Every field that shapes the
computation is static so configs hash cleanly into jit caches.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Literal

Family = Literal["dense", "moe", "ssm", "hybrid", "vlm", "audio"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    # --- attention pattern -------------------------------------------------
    # per-layer sliding window, cycled over layers; 0 = full/global attention
    window_pattern: tuple[int, ...] = (0,)
    rope_theta: float = 10_000.0
    # sliding-window decode variant (beyond-paper feature): when > 0,
    # serve_step masks decode attention to the trailing `decode_window`
    # cache entries, making long-context decode sub-quadratic in aggregate.
    decode_window: int = 0
    # ring-buffer KV cache (beyond-paper §Perf optimization): with
    # decode_window > 0, allocate only `decode_window` cache slots and
    # write decode tokens at pos % window — drops the decode memory term
    # from O(seq_len) to O(window).
    ring_cache: bool = False
    # --- MoE ---------------------------------------------------------------
    num_experts: int = 0
    experts_per_token: int = 0
    moe_capacity_factor: float = 1.25
    # "scatter" (scalable, default) | "dense" (GShard one-hot; O(T·E·C) —
    # kept for the §Perf A/B and tiny configs)
    moe_dispatch: str = "scatter"

    # --- SSM (mamba2) ------------------------------------------------------
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_groups: int = 1
    ssm_chunk: int = 256
    d_conv: int = 4
    # --- hybrid (recurrentgemma): per-layer block type, cycled -------------
    # "a" = attention, "r" = RG-LRU recurrent block
    block_pattern: tuple[str, ...] = ("a",)
    d_rnn: int = 0
    # --- norms / misc ------------------------------------------------------
    norm_type: str = "rmsnorm"  # "rmsnorm" | "nonparametric_ln"
    tie_embeddings: bool = True
    gated_mlp: bool = True
    # --- enc-dec (audio) ----------------------------------------------------
    encoder_layers: int = 0
    encoder_frames: int = 0   # stub frontend output length (precomputed embeds)
    # --- vlm ----------------------------------------------------------------
    num_patches: int = 0      # stub vision frontend output length
    # --- numerics -----------------------------------------------------------
    remat: bool = True
    param_dtype: str = "bfloat16"   # "bfloat16" (TPU) | "float32" (CPU tests)
    source: str = ""          # citation for the assigned config

    # ------------------------------------------------------------------
    def layer_windows(self) -> tuple[int, ...]:
        p = self.window_pattern
        return tuple(p[i % len(p)] for i in range(self.num_layers))

    def layer_blocks(self) -> tuple[str, ...]:
        p = self.block_pattern
        return tuple(p[i % len(p)] for i in range(self.num_layers))

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    # ------------------------------------------------------------------
    # Parameter / cost accounting (drives the router cost model + roofline)
    # ------------------------------------------------------------------
    def param_count(self) -> int:
        D, F, V, L = self.d_model, self.d_ff, self.vocab_size, self.num_layers
        embed = V * D * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.family in ("dense", "moe", "vlm", "audio"):
            attn = D * self.num_heads * self.head_dim * 2 + \
                D * self.num_kv_heads * self.head_dim * 2
            per_layer += attn
            if self.family == "moe":
                per_layer += self.num_experts * D * F * 3 + D * self.num_experts
            else:
                per_layer += D * F * (3 if self.gated_mlp else 2)
        elif self.family == "ssm":
            di, gn = self.d_inner, self.ssm_groups * self.ssm_state
            per_layer += D * (2 * di + 2 * gn + self.ssm_heads) + di * D
        elif self.family == "hybrid":
            # average over the block pattern
            attn = D * self.num_heads * self.head_dim * 2 + \
                D * self.num_kv_heads * self.head_dim * 2
            rglru = 2 * D * self.d_rnn + 2 * self.d_rnn ** 2 + self.d_rnn * D
            blocks = self.layer_blocks()
            frac_a = blocks.count("a") / len(blocks)
            per_layer += attn * frac_a + rglru * (1 - frac_a)
            per_layer += D * F * 3
        total = embed + L * per_layer
        if self.family == "audio":
            total += self.encoder_layers * (
                D * self.num_heads * self.head_dim * 2 +
                D * self.num_kv_heads * self.head_dim * 2 + D * F * 3)
            total += L * (D * self.num_heads * self.head_dim * 2 +
                          D * self.num_kv_heads * self.head_dim * 2)  # cross-attn
        return int(total)

    def active_param_count(self) -> int:
        """MoE-aware active parameters (for 6·N_active·D cost accounting)."""
        if self.family != "moe":
            return self.param_count()
        D, F, L = self.d_model, self.d_ff, self.num_layers
        dense_part = self.param_count() - L * self.num_experts * D * F * 3
        return int(dense_part + L * self.experts_per_token * D * F * 3)

    def flops_per_token(self) -> float:
        return 6.0 * self.active_param_count()


def assert_valid(cfg: ModelConfig) -> None:
    if cfg.family in ("dense", "moe", "vlm", "audio", "hybrid"):
        assert cfg.num_heads % cfg.num_kv_heads == 0, cfg.name
    if cfg.family == "moe":
        assert 0 < cfg.experts_per_token <= cfg.num_experts, cfg.name
    if cfg.family == "ssm":
        assert cfg.d_inner % cfg.ssm_head_dim == 0, cfg.name
    if cfg.family == "hybrid":
        assert cfg.d_rnn > 0, cfg.name
    if cfg.family == "audio":
        assert cfg.encoder_layers > 0 and cfg.encoder_frames > 0, cfg.name
    if cfg.family == "vlm":
        assert cfg.num_patches > 0, cfg.name
