"""DeepSeek-Coder-33B [arXiv:2401.14196] — llama-architecture dense GQA.

Largest dense config in the pool; the FSDP-vs-TP sharding split matters
most here (33B params → AdamW state must shard over both mesh axes).
"""
import dataclasses

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="deepseek-coder-33b",
    family="dense",
    num_layers=62,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=19200,
    vocab_size=32256,
    rope_theta=100_000.0,
    norm_type="rmsnorm",
    tie_embeddings=False,
    source="[arXiv:2401.14196] llama-arch",
)

SMOKE = dataclasses.replace(
    FULL, name="deepseek-coder-33b-smoke", num_layers=2, d_model=128,
    num_heads=4, num_kv_heads=2, head_dim=32, d_ff=256, vocab_size=512,
    remat=False, param_dtype="float32")
