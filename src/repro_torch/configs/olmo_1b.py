"""OLMo-1B [arXiv:2402.00838] — dense decoder with **non-parametric
LayerNorm** (no learned scale/bias)."""
import dataclasses

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="olmo-1b",
    family="dense",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=8192,
    vocab_size=50304,
    rope_theta=10_000.0,
    norm_type="nonparametric_ln",
    tie_embeddings=True,
    source="[arXiv:2402.00838] non-parametric LN",
)

SMOKE = dataclasses.replace(
    FULL, name="olmo-1b-smoke", num_layers=2, d_model=128, num_heads=4,
    num_kv_heads=4, head_dim=32, d_ff=256, vocab_size=512, remat=False, param_dtype="float32")
