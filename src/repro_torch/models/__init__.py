from repro_torch.models.config import ModelConfig, assert_valid
from repro_torch.models.model import (decode_step, embed_tokens, forward,
                                      init_cache, init_params, loss_fn,
                                      output_logits, param_shapes, prefill)

__all__ = ["ModelConfig", "assert_valid", "decode_step", "embed_tokens",
           "forward", "init_cache", "init_params", "loss_fn",
           "output_logits", "param_shapes", "prefill"]
