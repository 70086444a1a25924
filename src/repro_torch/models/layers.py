"""Transformer layers, the counterpart of the dense and MoE layers of
``src/repro/models/layers.py``.

Conventions kept from the JAX package, so parameters carry across as they
are (:mod:`repro_torch.bridge`) and the two packages round where each
other rounds:

* parameters are nested dicts of tensors; attention projections keep an
  explicit head axis (``wq`` (D, H, hd), ``wo`` (H, hd, D));
* products accumulate in f32 and are cast back to the activation dtype at
  the same points as the JAX ``preferred_element_type=f32`` einsums.
  Where JAX keeps such a product in f32 (the MLP's gate/up, the logits),
  :func:`matmul_f32` keeps it too: on the card a bf16 GEMM that writes
  f32, on the CPU a product of the operands upcast to f32 (exact, since
  the products of bf16 values are exact in f32).

Serving does not call :func:`attention`: the model sends it to the
kernels through :mod:`repro_torch.kernels.ops` (flash attention for
sequences, decode attention for one step). :func:`attention` is the
model-level attention of the training forward, plain differentiable
PyTorch; the kernels are forward-only.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

Params = dict[str, Any]


# ---------------------------------------------------------------------------
# Initializers (torch.Generator streams: same distributions as the JAX
# package, not the same numbers)
# ---------------------------------------------------------------------------


def normal(gen: torch.Generator, shape, std: float, dtype,
           device) -> torch.Tensor:
    x = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=device)
    return (x * std).to(dtype)


def dense_init(gen, shape, in_axis: int, dtype, device) -> torch.Tensor:
    """Fan-in scaled normal init (``layers.dense_init``) on ``device``, the
    generator's."""
    return normal(gen, shape, shape[in_axis] ** -0.5, dtype, device)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rmsnorm(params: Params, x: torch.Tensor, eps: float = 1e-6):
    """Zero-centred RMSNorm: the stored scale is the delta from 1."""
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + params["scale"])).to(dtype)


def nonparametric_layernorm(x: torch.Tensor, eps: float = 1e-5):
    """LayerNorm without learned scale or bias."""
    dtype = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, unbiased=False)
    return ((x - mu) * torch.rsqrt(var + eps)).to(dtype)


def apply_norm(norm_type: str, params: Params | None, x: torch.Tensor):
    if norm_type == "nonparametric_ln":
        return nonparametric_layernorm(x)
    return rmsnorm(params, x)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float, device) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x (B, S, H, hd); positions (B, S) int."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)
    angles = positions[..., None].float() * freqs
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA masked by positions, optional sliding window)
# ---------------------------------------------------------------------------

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def _attn_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, window: int,
               causal: bool) -> torch.Tensor:
    """Boolean mask (B, Sq, Sk); negative key positions are always
    masked."""
    diff = q_pos[..., :, None] - k_pos[..., None, :]
    mask = (k_pos >= 0)[..., None, :].expand_as(diff)
    if causal:
        mask = mask & (diff >= 0)
    if window > 0:
        mask = mask & (diff < window)
    return mask


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              q_positions: torch.Tensor, k_positions: torch.Tensor,
              causal: bool = True, window: int = 0,
              softmax_scale: float | None = None) -> torch.Tensor:
    """Grouped-query attention, ``layers.attention`` of the JAX package.

    q (B, Sq, H, hd); k, v (B, Sk, KV, hd), H % KV == 0; positions (B, Sq)
    and (B, Sk). Scores and the output accumulate in f32 (operands upcast,
    exact for bf16), probabilities are cast to v's dtype, the output to
    q's. The whole (Sq, Sk) score matrix is formed at once: the JAX
    version's chunked online softmax for Sk > 1024 is the same function
    in another summation order.
    """
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    scale = softmax_scale if softmax_scale is not None else hd ** -0.5
    qg = q.reshape(B, Sq, KV, H // KV, hd) * scale
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg.float(), k.float())
    mask = _attn_mask(q_positions, k_positions, window, causal)
    scores = torch.where(mask[:, None, None], scores,
                         torch.tensor(NEG_INF, device=scores.device))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskh->bqkgh", probs.float(), v.float())
    return out.reshape(B, Sq, H, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# Attention projections
# ---------------------------------------------------------------------------


def proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """bsd,dhk->bshk, accumulated in f32, in x's dtype."""
    B, S, D = x.shape
    return (x @ w.reshape(D, -1)).view(B, S, w.shape[1], w.shape[2])


def attention_qkv(params: Params, x: torch.Tensor, positions: torch.Tensor,
                  theta: float):
    q = apply_rope(proj(x, params["wq"]), positions, theta)
    k = apply_rope(proj(x, params["wk"]), positions, theta)
    v = proj(x, params["wv"]).contiguous()
    return q, k, v


def attention_out(params: Params, attn: torch.Tensor) -> torch.Tensor:
    """bshk,hkd->bsd in attn's dtype."""
    B, S, H, hd = attn.shape
    return attn.reshape(B, S, H * hd) @ params["wo"].reshape(H * hd, -1)


# ---------------------------------------------------------------------------
# MLP and output head
# ---------------------------------------------------------------------------


def _recorded(*ts: torch.Tensor) -> bool:
    """Whether autograd records a product of ``ts``: ``mm``/``bmm`` with
    ``out_dtype`` have no derivative, so such a product upcasts instead."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., D) @ w (D, F) with an f32 result, whatever the operands'
    dtype: ``preferred_element_type=f32``. A bf16 product on the card is
    one bf16 GEMM that writes f32 (the weights are read as they are, not
    upcast per call); on the CPU, which has no such GEMM, and in training,
    where autograd records the product (:func:`_recorded`), both operands
    are upcast."""
    if x.dtype == torch.float32 and w.dtype == torch.float32:
        return x @ w
    if x.device.type == "cuda" and not _recorded(x, w):
        out = torch.mm(x.reshape(-1, x.shape[-1]), w,
                       out_dtype=torch.float32)
        return out.view(*x.shape[:-1], w.shape[1])
    return x.float() @ w.float()


def mlp(params: Params, x: torch.Tensor) -> torch.Tensor:
    up = matmul_f32(x, params["w_up"])
    if "w_gate" in params:
        h = F.silu(matmul_f32(x, params["w_gate"])) * up
    else:
        h = F.gelu(up, approximate="tanh")
    return h.to(x.dtype) @ params["w_down"]


def unembed(embedding: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Logits (B, S, V) in f32 from x (B, S, D) and a (V, D) table."""
    return matmul_f32(x, embedding.T)


# ---------------------------------------------------------------------------
# Mixture of Experts (top-k token choice, per-row capacity dispatch)
# ---------------------------------------------------------------------------


def moe_init(gen, d_model: int, d_ff: int, num_experts: int, dtype,
             device) -> Params:
    """One MoE layer's weights (``layers.moe_init``): the f32 router
    (D, E) and the experts' ``w_gate``/``w_up`` (E, D, F) and ``w_down``
    (E, F, D) in ``dtype``, fan-in normal."""
    D, F_, E = d_model, d_ff, num_experts
    return {"router": dense_init(gen, (D, E), 0, torch.float32, device),
            "w_gate": dense_init(gen, (E, D, F_), 1, dtype, device),
            "w_up": dense_init(gen, (E, D, F_), 1, dtype, device),
            "w_down": dense_init(gen, (E, F_, D), 1, dtype, device)}


def _bmm_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (E, N, D) @ w (E, D, F) -> (E, N, F) f32, per expert: the batched
    :func:`matmul_f32` (``preferred_element_type=f32``)."""
    if x.dtype == torch.float32 and w.dtype == torch.float32:
        return torch.bmm(x, w)
    if x.device.type == "cuda" and not _recorded(x, w):
        return torch.bmm(x, w, out_dtype=torch.float32)
    return torch.bmm(x.float(), w.float())


def _top_k_lowest_first(probs: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last axis: the k largest, ties to the
    lower index (a stable descending sort; ``torch.topk`` leaves the order
    of ties unspecified)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_route(params: Params, x: torch.Tensor, k: int,
              capacity_factor: float):
    """The routing half of :func:`moe`: the f32 router's softmax, its top
    k (ties to the lower expert), the gates renormalised over the k, the
    Switch aux loss; each (token, slot) takes the next place of its
    expert's buffer in the row, in (S, k) order, and past the capacity
    ``max(1, int(cf * k * S / E))`` it is dropped (gate 0). Returns
    (gate_vals (B, S, k) f32, expert_idx (B, S, k), pos (B, S, k), keep
    (B, S, k) bool, capacity, aux)."""
    B, S, _ = x.shape
    E = params["router"].shape[1]
    probs = torch.softmax(x.float() @ params["router"], dim=-1)   # (B, S, E)
    gate_vals, expert_idx = _top_k_lowest_first(probs, k)         # (B, S, k)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    me = probs.mean(dim=(0, 1))
    ce = F.one_hot(expert_idx, E).float().sum(2).mean(dim=(0, 1))
    aux = E * (me * ce).sum()

    capacity = max(1, int(capacity_factor * k * S / E))
    flat = F.one_hot(expert_idx, E).reshape(B, S * k, E)
    pos = ((flat.cumsum(1) - flat) * flat).sum(-1).reshape(B, S, k)
    keep = pos < capacity
    return (gate_vals * keep.to(gate_vals.dtype), expert_idx, pos, keep,
            capacity, aux)


def moe(params: Params, x: torch.Tensor, *, experts_per_token: int,
        capacity_factor: float = 1.25, dispatch: str = "scatter"):
    """Top-k token-choice MoE with per-row capacity, ``layers.moe`` of the
    JAX package: returns (output (B, S, D) in x's dtype, the Switch
    load-balance aux loss, f32 scalar). Routing is :func:`moe_route`.

    ``scatter`` (the default) writes the kept tokens into a (B, E, C + 1,
    D) buffer whose last place takes the dropped ones and is sliced off,
    and gathers the outputs back by (expert, place); ``dense`` dispatches
    and combines with one-hot einsums. The expert products accumulate in
    f32 and are cast to x's dtype where JAX casts them; these are large
    plain products, so they stay batched matmuls."""
    B, S, D = x.shape
    E = params["w_gate"].shape[0]
    k = experts_per_token
    gate_vals, expert_idx, pos, keep, capacity, aux = moe_route(
        params, x, k, capacity_factor)

    if dispatch == "dense":
        pos_oh = F.one_hot(torch.where(keep, pos, capacity), capacity + 1
                           )[..., :capacity].float()              # (B,S,k,C)
        oh = F.one_hot(expert_idx, E).float()
        disp = torch.einsum("bske,bskc->bsec", oh, pos_oh)
        comb = torch.einsum("bske,bskc,bsk->bsec", oh, pos_oh, gate_vals)
        expert_in = torch.einsum("bsec,bsd->becd", disp,
                                 x.float()).to(x.dtype)
    else:
        safe_pos = torch.where(keep, pos, capacity)
        bidx = torch.arange(B, device=x.device)[:, None, None].expand(B, S, k)
        buf = torch.zeros((B, E, capacity + 1, D), dtype=x.dtype,
                          device=x.device)
        buf = buf.index_put((bidx, expert_idx, safe_pos),
                            x[:, :, None, :].expand(B, S, k, D),
                            accumulate=True)
        expert_in = buf[:, :, :capacity]                          # (B,E,C,D)

    xe = expert_in.transpose(0, 1).reshape(E, B * capacity, D)
    gate = _bmm_f32(xe, params["w_gate"])
    up = _bmm_f32(xe, params["w_up"])
    h = (F.silu(gate) * up).to(x.dtype)
    expert_out = _bmm_f32(h, params["w_down"]).to(x.dtype).reshape(
        E, B, capacity, D).transpose(0, 1)                        # (B,E,C,D)

    if dispatch == "dense":
        out = torch.einsum("bsec,becd->bsd", comb, expert_out.float())
    else:
        gathered = expert_out[bidx, expert_idx,
                              safe_pos.clamp(max=capacity - 1)]   # (B,S,k,D)
        out = (gathered.float() * gate_vals[..., None]).sum(2)
    return out.to(x.dtype), aux
