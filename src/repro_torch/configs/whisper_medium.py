"""Whisper-medium [arXiv:2212.04356] — encoder-decoder; the conv/mel
frontend is a STUB per the brief: ``input_specs`` provides precomputed
frame embeddings (B, 1500, d_model); we implement the transformer
encoder + decoder backbone.

Adaptations recorded in DESIGN.md: RoPE instead of learned positions,
RMSNorm instead of biased LayerNorm (TPU-idiomatic conventions; dims are
the assigned whisper-medium dims). long_500k is skipped for this arch —
a 500k-token decoder cache contradicts the enc-dec design (448-token
decoder context in the source model).
"""
import dataclasses

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="whisper-medium",
    family="audio",
    num_layers=24,             # decoder layers
    encoder_layers=24,
    encoder_frames=1500,       # 30 s of audio after the (stubbed) conv stack
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=51865,
    gated_mlp=False,           # whisper uses plain GELU MLPs
    rope_theta=10_000.0,
    norm_type="rmsnorm",
    tie_embeddings=True,
    source="[arXiv:2212.04356] enc-dec, conv frontend (stub)",
)

SMOKE = dataclasses.replace(
    FULL, name="whisper-medium-smoke", num_layers=2, encoder_layers=2,
    encoder_frames=16, d_model=128, num_heads=4, num_kv_heads=4,
    head_dim=32, d_ff=256, vocab_size=512, remat=False, param_dtype="float32")
