"""Gemma-3-27B [hf:google/gemma-3-1b-pt family] — dense GQA with 5:1
local:global attention (window 1024 local layers), 128k context, 256k vocab.

The 5:1 interleave rides through the layer scan as a per-layer window array;
the §Perf log shows the static-window superblock variant.
"""
import dataclasses

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="gemma3-27b",
    family="dense",
    num_layers=62,
    d_model=5376,
    num_heads=32,
    num_kv_heads=16,
    head_dim=128,
    d_ff=21504,
    vocab_size=262144,
    window_pattern=(1024, 1024, 1024, 1024, 1024, 0),  # 5 local : 1 global
    rope_theta=1_000_000.0,
    norm_type="rmsnorm",
    tie_embeddings=True,
    source="[hf:google/gemma-3-1b-pt] 5:1 local:global, 128k context",
)

SMOKE = dataclasses.replace(
    FULL, name="gemma3-27b-smoke", num_layers=2, d_model=128, num_heads=4,
    num_kv_heads=2, head_dim=32, d_ff=256, vocab_size=512,
    window_pattern=(8, 0), remat=False, param_dtype="float32")
