"""Llama-3-8B [arXiv:2407.21783] — dense GQA decoder, 128k vocab.

The paper's own evaluation uses Llama-3-70B-instruct as one of its *strong*
FMs; the 8B sibling is the assigned pool config and slots into RAR as
either tier.
"""
import dataclasses

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="llama3-8b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=128256,
    rope_theta=500_000.0,
    norm_type="rmsnorm",
    tie_embeddings=False,
    source="[arXiv:2407.21783] GQA, 128k vocab",
)

SMOKE = dataclasses.replace(
    FULL, name="llama3-8b-smoke", num_layers=2, d_model=128, num_heads=4,
    num_kv_heads=2, head_dim=32, d_ff=256, vocab_size=512, remat=False, param_dtype="float32")
