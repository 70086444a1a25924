"""RecurrentGemma-2B [arXiv:2402.19427] — Griffin hybrid: RG-LRU recurrent
blocks and local attention in a 2:1 pattern (r, r, a), window 2048,
MQA (kv=1, head_dim 256), d_rnn = 2560.

Hybrid tier for RAR: recurrent state keeps decode O(1) on most layers;
long_500k runs natively.
"""
import dataclasses

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    block_pattern=("r", "r", "a"),
    window_pattern=(2048,),    # local attention on the attention layers
    d_rnn=2560,
    d_conv=4,
    rope_theta=10_000.0,
    norm_type="rmsnorm",
    tie_embeddings=True,
    source="[arXiv:2402.19427] RG-LRU + local attn, 1:2",
)

SMOKE = dataclasses.replace(
    FULL, name="recurrentgemma-smoke", num_layers=3, d_model=128,
    num_heads=4, num_kv_heads=1, head_dim=32, d_ff=256, vocab_size=512,
    window_pattern=(16,), d_rnn=128, remat=False, param_dtype="float32")
