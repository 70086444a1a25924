from repro_torch.models.config import ModelConfig, assert_valid
from repro_torch.models.model import (decode_step, embed_tokens, init_cache,
                                      init_params, output_logits, prefill)

__all__ = ["ModelConfig", "assert_valid", "decode_step", "embed_tokens",
           "init_cache", "init_params", "output_logits", "prefill"]
