"""Analytic per-device roofline terms from first principles: a copy of
``src/repro/launch/analytic.py`` (the same arithmetic, so the terms equal
the reference's to the last bit; the roofline divides them by the H100
constants of :mod:`repro_torch.launch.mesh`).

The dry run (:mod:`repro_torch.launch.dryrun`) records these terms beside
the ones it counts while the step runs.

Model (per device, per step):

* FLOPs — matmul-dominated: 2·N_active·T_tokens (×3 for fwd+bwd) + exact
  attention-score FLOPs (windowed layers counted at their window).
* HBM bytes — weights read (TP-sharded once per step; ×(1+2) for train
  where grads+optimizer are touched), KV/state cache read+write, residual
  activations (remat-aware: one carry per layer, ×microbatching).
"""
from __future__ import annotations

from repro_torch.models.config import ModelConfig


def _attn_flops(cfg: ModelConfig, T_q: float, ctx: float, causal_frac: float
                ) -> float:
    """Score+PV flops across layers, window-aware. Per *global* step."""
    if cfg.family == "ssm":
        return 0.0
    total = 0.0
    hd, H = cfg.head_dim, cfg.num_heads
    layers = (cfg.layer_blocks() if cfg.family == "hybrid"
              else ["a"] * cfg.num_layers)
    windows = cfg.layer_windows()
    wi = 0
    for b in layers:
        if b != "a":
            continue
        w = windows[wi % len(windows)]
        wi += 1
        eff_ctx = min(ctx, w) if w > 0 else ctx
        if cfg.decode_window > 0 and w == 0 and T_q == 1:
            eff_ctx = min(ctx, cfg.decode_window)
        total += 4.0 * T_q * eff_ctx * H * hd * causal_frac
    if cfg.family == "audio":
        total += cfg.encoder_layers * 4.0 * cfg.encoder_frames ** 2 * H * hd
        total += cfg.num_layers * 4.0 * T_q * cfg.encoder_frames * H * hd
    return total


def analytic_terms(cfg: ModelConfig, kind: str, batch: int, seq: int,
                   n_chips: int, grad_accum: int = 1) -> dict:
    """Per-device flops and HBM bytes for one step of ``kind``."""
    N = cfg.active_param_count()
    w_bytes = 2.0 * cfg.param_count()          # bf16 weights
    model_shards = 16                          # TP degree on every mesh

    if kind == "train":
        tokens = batch * seq
        flops = 6.0 * N * tokens + 3.0 * _attn_flops(cfg, seq, seq, 0.5) \
            * batch
        # weights+grads+adam state touched once; activations: remat carry
        # per layer per microbatch + recompute reads
        act = (batch / 16) * seq * cfg.d_model * 2 * \
            (cfg.num_layers + cfg.encoder_layers) / max(grad_accum, 1)
        # weights + f32 master/mu/nu (14 B/param, FSDP-sharded) touched per
        # microbatch (the re-gathered weights), activations written+read+
        # recomputed under remat
        hbm_per_dev = 14.0 * cfg.param_count() / n_chips * grad_accum \
            + act * 3
        return {"flops_per_device": flops / n_chips,
                "hbm_bytes_per_device": hbm_per_dev}

    if kind == "prefill":
        tokens = batch * seq
        flops = 2.0 * N * tokens + _attn_flops(cfg, seq, seq, 0.5) * batch
        cache = _cache_bytes(cfg, batch, seq)
        hbm_per_dev = w_bytes / model_shards + cache / n_chips + \
            (batch / 16) * seq * cfg.d_model * 2 * 2
        return {"flops_per_device": flops / n_chips,
                "hbm_bytes_per_device": hbm_per_dev}

    # decode: one token per row against a `seq`-entry cache
    flops = 2.0 * N * batch + _attn_flops(cfg, 1, seq, 1.0) * batch
    cache = _cache_bytes(cfg, batch, seq)
    hbm_per_dev = w_bytes / model_shards + cache / n_chips * 2  # r+w
    return {"flops_per_device": flops / n_chips,
            "hbm_bytes_per_device": hbm_per_dev}


def _cache_bytes(cfg: ModelConfig, batch: int, seq: int) -> float:
    """Global cache bytes (bf16 KV / f32 SSD state), ring-aware."""
    M = seq
    if cfg.ring_cache and cfg.decode_window > 0:
        M = min(seq, cfg.decode_window)
    kv_layers = {"dense": cfg.num_layers, "moe": cfg.num_layers,
                 "vlm": cfg.num_layers, "audio": cfg.num_layers,
                 "hybrid": cfg.layer_blocks().count("a"),
                 "ssm": 0}[cfg.family]
    kv = kv_layers * batch * M * cfg.num_kv_heads * cfg.head_dim * 2 * 2
    if cfg.family == "ssm":
        kv += cfg.num_layers * batch * cfg.ssm_heads * cfg.ssm_head_dim * \
            cfg.ssm_state * 4
    if cfg.family == "hybrid":
        n_rec = cfg.layer_blocks().count("r")
        kv += n_rec * batch * cfg.d_rnn * 4
    if cfg.family == "audio":
        kv += cfg.num_layers * batch * cfg.encoder_frames * \
            cfg.num_kv_heads * cfg.head_dim * 2 * 2
    return kv
