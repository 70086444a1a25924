"""OLMoE-1B-7B [arXiv:2409.02060] — 16L MoE, 64 experts top-8,
per-expert d_ff 1024. 64 experts divide the model axis exactly →
clean expert parallelism (4 experts per device group)."""
import dataclasses

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1024,                 # per expert
    vocab_size=50304,
    num_experts=64,
    experts_per_token=8,
    rope_theta=10_000.0,
    norm_type="rmsnorm",
    tie_embeddings=False,
    source="[arXiv:2409.02060] 64 experts top-8",
)

SMOKE = dataclasses.replace(
    FULL, name="olmoe-smoke", num_layers=2, d_model=128, num_heads=4,
    num_kv_heads=4, head_dim=32, d_ff=64, vocab_size=512, num_experts=4,
    experts_per_token=2, moe_capacity_factor=8.0, remat=False,
    param_dtype="float32")
