"""Mamba2-2.7B [arXiv:2405.21060] — attention-free SSM with SSD
(state-space duality). d_inner = 2×2560 = 5120, 80 heads of 64, state 128.

Natural *weak/edge* tier for RAR: O(1) decode state, no KV cache —
long_500k runs natively.
"""
import dataclasses

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    num_layers=64,
    d_model=2560,
    num_heads=0,
    num_kv_heads=1,
    head_dim=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_groups=1,
    ssm_chunk=256,
    d_conv=4,
    norm_type="rmsnorm",
    tie_embeddings=True,
    source="[arXiv:2405.21060] SSD (state-space duality)",
)

SMOKE = dataclasses.replace(
    FULL, name="mamba2-2.7b-smoke", num_layers=2, d_model=128,
    vocab_size=512, ssm_state=16, ssm_head_dim=32, ssm_chunk=16, remat=False, param_dtype="float32")
