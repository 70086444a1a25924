"""RAR core of the port: decision core, guide store (with its write-ahead
journal, and its sharded form), FM tiers, the sequential and microbatched
controllers and the shadow queue in every drain mode.

Equivalence chain, as in the JAX package: sequential == microbatch B=1 ==
deferred flush-every-batch == async with a barrier after every batch ==
adaptive under an always-drain policy (``tests/test_torch_shadow.py``,
``tests/test_torch_metrics.py``)."""
from repro_torch.core.rar import RAR, RARConfig, Outcome, splice_guide
from repro_torch.core.pipeline import MicrobatchRAR
from repro_torch.core.shadow import ShadowItem, ShadowQueue
from repro_torch.core.memory_sharded import ShardedMemory
from repro_torch.core.fm import (FMTier, ResilientTier, RetryPolicy,
                                 CircuitBreaker, TierError,
                                 TransientTierError, TierTimeout,
                                 TierUnavailableError)
from repro_torch.core import decisions, memory, embedder, router

__all__ = ["RAR", "RARConfig", "Outcome", "splice_guide", "MicrobatchRAR",
           "ShadowItem", "ShadowQueue", "ShardedMemory", "FMTier",
           "ResilientTier", "RetryPolicy", "CircuitBreaker", "TierError",
           "TransientTierError", "TierTimeout", "TierUnavailableError",
           "decisions", "memory", "embedder", "router"]
