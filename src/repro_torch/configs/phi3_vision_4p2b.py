"""Phi-3-Vision-4.2B [hf:microsoft/Phi-3-vision-128k-instruct] — phi3-mini
language backbone + CLIP vision tower (STUB per the brief: ``input_specs``
provides precomputed patch embeddings at d_model; we implement the decoder
that consumes them).
"""
import dataclasses

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,
    head_dim=96,
    d_ff=8192,
    vocab_size=32064,
    num_patches=256,          # stub vision frontend output length
    rope_theta=10_000.0,
    norm_type="rmsnorm",
    tie_embeddings=False,
    source="[hf:microsoft/Phi-3-vision-128k-instruct] phi3-mini + CLIP (stub)",
)

SMOKE = dataclasses.replace(
    FULL, name="phi-3-vision-4.2b-smoke", num_layers=2, d_model=128,
    num_heads=4, num_kv_heads=4, head_dim=32, d_ff=256, vocab_size=512,
    num_patches=8, remat=False, param_dtype="float32")
