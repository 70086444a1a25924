"""Granite-MoE-3B-A800M [hf:ibm-granite/granite-3.0 family] — 32L MoE,
40 experts top-8, per-expert d_ff 512.

Notes: 24 heads and 40 experts do **not** divide the 16-way model axis —
the divisibility-fallback sharding rules route TP through d_model / d_ff
instead (see models/sharding.py); this config is the stress test for them.
"""
import dataclasses

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    num_layers=32,
    d_model=1536,
    num_heads=24,
    num_kv_heads=8,
    head_dim=64,
    d_ff=512,                  # per expert
    vocab_size=49155,
    num_experts=40,
    experts_per_token=8,
    rope_theta=10_000.0,
    norm_type="rmsnorm",
    tie_embeddings=True,
    source="[hf:ibm-granite/granite-3.0-1b-a400m-base] 32 experts top-8 family",
)

SMOKE = dataclasses.replace(
    FULL, name="granite-moe-smoke", num_layers=2, d_model=128, num_heads=4,
    num_kv_heads=2, head_dim=32, d_ff=64, vocab_size=512, num_experts=4,
    experts_per_token=2, moe_capacity_factor=8.0, remat=False,
    param_dtype="float32")
