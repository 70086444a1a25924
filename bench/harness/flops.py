"""Operations a forward needs, from the shapes (``launch/analytic.py``'s
arithmetic, counted per call): 2 per weight per token for the layer
stack (the MoE's router and its k experts per token, not all of them),
the attention products over the query-key pairs each query reads (4 per
pair and head dimension: scores and values), and the output head only
for the positions whose logits are computed. Embedding lookups and norms
are not counted."""
from __future__ import annotations


def layer_weights(m: dict) -> int:
    """Weights one token passes through in one layer (attention
    projections, then the MLP or the router and k experts)."""
    D, H, KV, hd, F = (m[k] for k in ("d_model", "num_heads", "num_kv_heads",
                                      "head_dim", "d_ff"))
    attn = D * hd * (2 * H + 2 * KV)
    E = m.get("num_experts", 0)
    if E:
        return attn + D * E + m["experts_per_token"] * 3 * D * F
    return attn + 3 * D * F


def prefill_flops(m: dict, batch: int, seq: int, logit_rows: int) -> float:
    """A prefill of ``batch`` rows of ``seq`` tokens with logits at
    ``logit_rows`` positions."""
    L, H, hd = m["num_layers"], m["num_heads"], m["head_dim"]
    body = 2.0 * layer_weights(m) * L * batch * seq
    attn = 2.0 * L * H * hd * batch * seq * (seq + 1)      # causal pairs
    head = 2.0 * m["d_model"] * m["vocab_size"] * logit_rows
    return body + attn + head


def decode_flops(m: dict, batch: int, keys: int) -> float:
    """One decode step of ``batch`` rows reading ``keys`` cached keys."""
    L, H, hd = m["num_layers"], m["num_heads"], m["head_dim"]
    return (2.0 * layer_weights(m) * L * batch + 4.0 * L * H * hd * batch *
            keys + 2.0 * m["d_model"] * m["vocab_size"] * batch)


def generate_flops(m: dict, lengths, max_new: int) -> float:
    """Greedy generation of ``max_new`` tokens after each prompt length."""
    total = 0.0
    for n in lengths:
        total += prefill_flops(m, 1, n, 1)
        for j in range(1, max_new):
            total += decode_flops(m, 1, n + j)
    return total


def encoder_flops(e: dict, live_lengths, out_dim: int) -> float:
    """The bidirectional embedder over the live (non-PAD) tokens of each
    row: layers, attention over the live keys, the pooled projection."""
    D, H, F, L = e["d_model"], e["num_heads"], e["d_ff"], e["num_layers"]
    hd = D // H
    total = 0.0
    for n in live_lengths:
        total += 2.0 * (4 * D * D + 3 * D * F) * L * n
        total += 4.0 * L * H * hd * n * n
        total += 2.0 * D * out_dim
    return total
