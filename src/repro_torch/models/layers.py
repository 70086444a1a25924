"""Dense transformer layers, the counterpart of the dense subset of
``src/repro/models/layers.py``.

Conventions kept from the JAX package, so parameters carry across as they
are (:mod:`repro_torch.bridge`) and the two packages round where each
other rounds:

* parameters are nested dicts of tensors; attention projections keep an
  explicit head axis (``wq`` (D, H, hd), ``wo`` (H, hd, D));
* products accumulate in f32 and are cast back to the activation dtype at
  the same points as the JAX ``preferred_element_type=f32`` einsums.
  Where JAX keeps such a product in f32 (the MLP's gate/up, the logits),
  :func:`_matmul_f32` keeps it too: on the card a bf16 GEMM that writes
  f32, on the CPU a product of the operands upcast to f32 (exact, since
  the products of bf16 values are exact in f32).

Attention itself is not here: the model calls the kernels through
:mod:`repro_torch.kernels.ops` (flash attention for sequences, decode
attention for one step).
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
# Attention projections
# ---------------------------------------------------------------------------


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """bsd,dhk->bshk, accumulated in f32, in x's dtype."""
    B, S, D = x.shape
    return (x @ w.reshape(D, -1)).view(B, S, w.shape[1], w.shape[2])


def attention_qkv(params: Params, x: torch.Tensor, positions: torch.Tensor,
                  theta: float):
    q = apply_rope(_proj(x, params["wq"]), positions, theta)
    k = apply_rope(_proj(x, params["wk"]), positions, theta)
    v = _proj(x, params["wv"]).contiguous()
    return q, k, v


def attention_out(params: Params, attn: torch.Tensor) -> torch.Tensor:
    """bshk,hkd->bsd in attn's dtype."""
    B, S, H, hd = attn.shape
    return attn.reshape(B, S, H * hd) @ params["wo"].reshape(H * hd, -1)


# ---------------------------------------------------------------------------
# MLP and output head
# ---------------------------------------------------------------------------


def _matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., D) @ w (D, F) with an f32 result, whatever the operands'
    dtype: ``preferred_element_type=f32``. A bf16 product on the card is
    one bf16 GEMM that writes f32 (the weights are read as they are, not
    upcast per call); on the CPU, which has no such GEMM, both operands
    are upcast."""
    if x.dtype == torch.float32 and w.dtype == torch.float32:
        return x @ w
    if x.device.type == "cuda":
        out = torch.mm(x.reshape(-1, x.shape[-1]), w,
                       out_dtype=torch.float32)
        return out.view(*x.shape[:-1], w.shape[1])
    return x.float() @ w.float()


def mlp(params: Params, x: torch.Tensor) -> torch.Tensor:
    up = _matmul_f32(x, params["w_up"])
    if "w_gate" in params:
        h = F.silu(_matmul_f32(x, params["w_gate"])) * up
    else:
        h = F.gelu(up, approximate="tanh")
    return h.to(x.dtype) @ params["w_down"]


def unembed(embedding: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Logits (B, S, V) in f32 from x (B, S, D) and a (V, D) table."""
    return _matmul_f32(x, embedding.T)
