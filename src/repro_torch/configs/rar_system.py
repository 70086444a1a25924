"""The RAR evaluation system configs — the paper's own experiment models.

Analog mapping (paper → this framework):

* Mistral-7B-instruct (weak FM)  → ``WEAK``: 3-layer dense transformer
  trained on a *subset* of skills unaided + guide-following in-context.
* GPT-4o / Llama-3-70B (strong)  → ``STRONG``: 6-layer dense transformer
  trained on all skills + guide generation.
* all-MiniLM-L12-v2 (embedder)   → ``EMBEDDER``: 4-layer contrastive
  encoder, 384-d output, cosine indexing.

The cost asymmetry the router exploits is real: STRONG is ~9× the FLOPs
of WEAK per token. At production scale any zoo architecture slots into
either tier (``llama3_8b`` is the one the port serves at full width).
"""
import dataclasses

from repro_torch.core.embedder import EmbedderConfig
from repro_torch.core.rar import RARConfig
from repro_torch.data.tokenizer import Vocab
from repro_torch.models.config import ModelConfig

_VOCAB = Vocab(n_domains=3)

WEAK = ModelConfig(
    name="rar-weak",
    family="dense",
    num_layers=3,
    d_model=128,
    num_heads=4,
    num_kv_heads=4,
    head_dim=32,
    d_ff=384,
    vocab_size=_VOCAB.size,
    rope_theta=10_000.0,
    tie_embeddings=False,
    remat=False,
    param_dtype="float32",
    source="paper-analog: Mistral-7B (weak tier)",
)

STRONG = ModelConfig(
    name="rar-strong",
    family="dense",
    num_layers=4,
    d_model=192,
    num_heads=6,
    num_kv_heads=6,
    head_dim=32,
    d_ff=576,
    vocab_size=_VOCAB.size,
    rope_theta=10_000.0,
    tie_embeddings=False,
    remat=False,
    param_dtype="float32",
    source="paper-analog: gpt-4o / Llama-3-70B (strong tier)",
)

EMBEDDER = EmbedderConfig(
    vocab_size=_VOCAB.size,
    d_model=128,
    num_layers=4,
    num_heads=4,
    d_ff=256,
    embed_dim=384,
)

FULL = STRONG  # registry convention
SMOKE = dataclasses.replace(WEAK, name="rar-weak-smoke", num_layers=2)


def make_rar_config(*, sim_threshold: float = 0.6,
                    guide_sim_threshold: float | None = None,
                    retrieval_k: int = 1, max_guides: int | None = None,
                    shadow_mode: str = "inline",
                    shadow_flush_every: int | None = None,
                    shadow_dedup_sim: float | None = None,
                    retrieval_clusters: int = 0,
                    retrieval_probes: int = 4,
                    **kw) -> RARConfig:
    """The system's RARConfig defaults in one place (thresholds calibrated
    to ``EMBEDDER``, see :class:`repro_torch.core.rar.RARConfig`). The
    multi-guide knobs plumb straight through: ``retrieval_k`` widens every
    memory read to the top-k entries and ``max_guides`` (default: follow
    retrieval_k) caps how many retrieved guides are spliced into the weak
    FM's prompt. ``shadow_mode``/``shadow_flush_every``/
    ``shadow_dedup_sim`` schedule the shadow plane (inline per batch,
    deferred to barriers, on the async drainer's thread and stream, or
    when the adaptive cost model says so, with optional near-duplicate
    coalescing before each drain — :mod:`repro_torch.core.shadow`); the
    flush cadence defaults to every batch and coalescing defaults to off.
    ``retrieval_clusters``/``retrieval_probes`` configure the two-level
    (IVF) retrieval plane (:mod:`repro_torch.core.memory_ivf`); 0 clusters
    (the default) keeps the exact store scan."""
    if guide_sim_threshold is None:
        guide_sim_threshold = sim_threshold
    if max_guides is None:
        max_guides = retrieval_k
    if shadow_flush_every is None:
        shadow_flush_every = 1
    return RARConfig(sim_threshold=sim_threshold,
                     guide_sim_threshold=guide_sim_threshold,
                     retrieval_k=retrieval_k, max_guides=max_guides,
                     shadow_mode=shadow_mode,
                     shadow_flush_every=shadow_flush_every,
                     shadow_dedup_sim=shadow_dedup_sim,
                     retrieval_clusters=retrieval_clusters,
                     retrieval_probes=retrieval_probes,
                     **kw)
