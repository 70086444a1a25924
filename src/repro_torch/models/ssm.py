"""State-space and linear-recurrent layers, the counterpart of
``src/repro/models/ssm.py``.

* Mamba-2 SSD (state-space duality) [arXiv:2405.21060]: the chunked dual
  form, an intra-chunk masked product and a recurrence over chunk states.
* RG-LRU (RecurrentGemma / Griffin) [arXiv:2402.19427]: a linear scan for
  prefill, one fused step for decode.

Each has a sequence mode (prefill, training) and a step mode (decode).
The arithmetic is the JAX package's, cast for cast: the chunk math in f32,
products accumulated in f32 and cast back to the activation dtype where
JAX casts them. Two orders differ: the intra-chunk products contract in
torch's einsum order, and the RG-LRU scan is a log-depth doubling scan
over (a, b) pairs, where JAX runs ``lax.associative_scan``; both sum the
same terms in another order (the CPU twins hold them to JAX within
1e-5 relative at f32). Plain PyTorch: the JAX package computes these
outside any Pallas kernel.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L

Params = dict

RGLRU_C = 8.0


# ---------------------------------------------------------------------------
# Depthwise causal conv1d (the Mamba-2 and RG-LRU branches)
# ---------------------------------------------------------------------------


def conv1d_init(gen, channels: int, kernel: int, dtype, device) -> Params:
    return {"w": L.dense_init(gen, (kernel, channels), 0, dtype, device),
            "b": torch.zeros((channels,), dtype=dtype, device=device)}


def causal_conv1d(params: Params, x: torch.Tensor) -> torch.Tensor:
    """x (B, S, C) -> (B, S, C): depthwise causal convolution, SiLU, in
    f32, cast to x's dtype."""
    k = params["w"].shape[0]
    S = x.shape[1]
    pad = F.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(k):      # k is 4: unrolled adds, as JAX
        out = out + pad[:, i:i + S].float() * params["w"][i]
    return F.silu(out + params["b"]).to(x.dtype)


def causal_conv1d_step(params: Params, x_t: torch.Tensor, buf: torch.Tensor):
    """One decode step. x_t (B, C); buf (B, k-1, C), the previous inputs.
    Returns (output (B, C), the new buffer)."""
    window = torch.cat([buf, x_t[:, None, :]], dim=1)          # (B, k, C)
    out = torch.einsum("bkc,kc->bc", window.float(), params["w"].float())
    out = F.silu(out + params["b"]).to(x_t.dtype)
    return out, window[:, 1:, :]


# ---------------------------------------------------------------------------
# Mamba-2 SSD
# ---------------------------------------------------------------------------


def mamba2_init(gen, d_model: int, *, d_state: int, head_dim: int,
                expand: int = 2, n_groups: int = 1, d_conv: int = 4,
                dtype=torch.bfloat16, device="cpu") -> Params:
    d_inner = expand * d_model
    n_heads = d_inner // head_dim
    d_in_proj = 2 * d_inner + 2 * n_groups * d_state + n_heads
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "in_proj": L.dense_init(gen, (d_model, d_in_proj), 0, dtype, device),
        "conv": conv1d_init(gen, d_inner + 2 * n_groups * d_state, d_conv,
                            dtype, device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, n_heads, **f32)),
        "D": torch.ones((n_heads,), **f32),
        "dt_bias": torch.zeros((n_heads,), **f32),
        "norm": {"scale": torch.zeros((d_inner,), **f32)},
        "out_proj": L.dense_init(gen, (d_inner, d_model), 0, dtype, device),
    }


def _ssd_chunked(x, dt, A, B, C, chunk: int, h0=None):
    """SSD dual form. x (B, S, H, P); dt (B, S, H); A (H,) < 0; B, C
    (B, S, G, N). Returns (y (B, S, H, P) f32, the final state (B, H, P,
    N) f32)."""
    Bsz, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    if S % chunk:
        raise ValueError(f"seq {S} % chunk {chunk} != 0")
    nc = S // chunk
    rep = H // G

    xd = (x * dt[..., None]).float()                       # dt-weighted input
    a = A[None, None, :] * dt                              # (B,S,H) log-decay < 0
    xc = xd.reshape(Bsz, nc, chunk, H, P)
    ac = a.reshape(Bsz, nc, chunk, H)
    Bh = B.reshape(Bsz, nc, chunk, G, N).float().repeat_interleave(rep, 3)
    Ch = C.reshape(Bsz, nc, chunk, G, N).float().repeat_interleave(rep, 3)

    cum = torch.cumsum(ac, dim=2)                          # (B,nc,Q,H)
    # intra-chunk: L[q, s] = exp(cum[q] - cum[s]) for q >= s. Masked with
    # -inf BEFORE the exp (exp of the q < s values would overflow to inf,
    # and inf * 0 NaNs the backward pass).
    rel = cum[:, :, :, None, :] - cum[:, :, None, :, :]    # rel[b,c,q,s,h]
    causal = torch.ones((chunk, chunk), dtype=torch.bool,
                        device=x.device).tril()
    rel = rel.masked_fill(~causal[None, None, :, :, None], float("-inf"))
    Lm = torch.exp(rel)
    scores = torch.einsum("bcqhn,bcshn->bcqsh", Ch, Bh)
    y_diag = torch.einsum("bcqsh,bcshp->bcqhp", scores * Lm, xc)

    # chunk-final states: states[c] = sum_s exp(cum[last] - cum[s]) B_s x_s
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)      # (B,nc,Q,H)
    states = torch.einsum("bcshn,bcshp->bchpn",
                          Bh * decay_to_end[..., None], xc)

    # the recurrence over chunk states; h_prevs[c] is the state ENTERING c
    chunk_decay = torch.exp(cum[:, :, -1, :])              # (B,nc,H)
    h = (torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    h_prevs = torch.stack(h_prevs, dim=1)                  # (B,nc,H,P,N)

    # inter-chunk contribution: y_off[q] = C_q . (exp(cum[q]) * h_prev)
    y_off = torch.einsum("bcqhn,bchpn->bcqhp",
                         Ch * torch.exp(cum)[..., None], h_prevs)
    return (y_diag + y_off).reshape(Bsz, S, H, P), h


def _split_in_proj(zxbcdt, d_inner: int, GN: int):
    """z, x, B, C, dt of the input projection's last axis."""
    return torch.split(zxbcdt, [d_inner, d_inner, GN, GN,
                                zxbcdt.shape[-1] - 2 * d_inner - 2 * GN],
                       dim=-1)


def mamba2_seq(params: Params, x: torch.Tensor, *, d_state: int,
               head_dim: int, n_groups: int = 1, chunk: int = 256,
               state: Params | None = None):
    """Sequence mode. x (B, S, D) -> ((B, S, D), cache {"ssd", "conv"}).

    A length that is not a multiple of the chunk is zero-padded, and the
    padded steps get dt = 0: exact no-ops on the state (decay exp(0) = 1,
    input dt B x = 0). ``state`` supplies only the initial SSD state; as
    in JAX, the convolution here starts from zeros, not ``state["conv"]``.
    The conv cache holds the last k - 1 pre-activation conv inputs,
    left-padded with zeros for shorter prompts."""
    Bsz, S, _ = x.shape
    d_inner = params["out_proj"].shape[0]
    H = d_inner // head_dim
    GN = n_groups * d_state

    chunk = min(chunk, max(S, 1))
    Sp = -(-S // chunk) * chunk
    if Sp != S:
        x = F.pad(x, (0, 0, 0, Sp - S))

    zxbcdt = x @ params["in_proj"]
    z, xin, Bmat, Cmat, dt = _split_in_proj(zxbcdt, d_inner, GN)
    xbc = causal_conv1d(params["conv"], torch.cat([xin, Bmat, Cmat], -1))
    xin, Bmat, Cmat = torch.split(xbc, [d_inner, GN, GN], dim=-1)

    dt = F.softplus(dt.float() + params["dt_bias"])        # (B,Sp,H)
    if Sp != S:
        valid = (torch.arange(Sp, device=x.device) < S)[None, :, None]
        dt = dt * valid                                    # padded: no-op
    A = -torch.exp(params["A_log"])
    xh = xin.reshape(Bsz, Sp, H, head_dim)
    Bh = Bmat.reshape(Bsz, Sp, n_groups, d_state)
    Ch = Cmat.reshape(Bsz, Sp, n_groups, d_state)

    h0 = state["ssd"] if state is not None else None
    y, h_last = _ssd_chunked(xh, dt, A, Bh, Ch, chunk, h0)
    y = y + params["D"][None, None, :, None] * xh.float()
    y = y.reshape(Bsz, Sp, d_inner).to(x.dtype)
    if Sp != S:
        y, z, zxbcdt = y[:, :S], z[:, :S], zxbcdt[:, :S]
    y = L.rmsnorm(params["norm"], y * F.silu(z.float()).to(x.dtype))
    out = y @ params["out_proj"]
    k = params["conv"]["w"].shape[0]
    tail = zxbcdt[:, -(k - 1):, :]
    if tail.shape[1] < k - 1:                  # very short prompts
        tail = F.pad(tail, (0, 0, k - 1 - tail.shape[1], 0))
    pre = torch.cat([tail[..., d_inner:2 * d_inner],
                     tail[..., 2 * d_inner:2 * d_inner + 2 * GN]], dim=-1)
    return out, {"ssd": h_last, "conv": pre.to(x.dtype)}


def mamba2_step(params: Params, x_t: torch.Tensor, state: Params, *,
                d_state: int, head_dim: int, n_groups: int = 1):
    """Decode step. x_t (B, D); state {"ssd": (B, H, P, N) f32, "conv":
    (B, k-1, C)}. Returns ((B, D), the new state)."""
    Bsz = x_t.shape[0]
    d_inner = params["out_proj"].shape[0]
    H = d_inner // head_dim
    GN = n_groups * d_state

    zxbcdt = x_t @ params["in_proj"]
    z, xin, Bmat, Cmat, dt = _split_in_proj(zxbcdt, d_inner, GN)
    xbc, conv_buf = causal_conv1d_step(
        params["conv"], torch.cat([xin, Bmat, Cmat], -1), state["conv"])
    xin, Bmat, Cmat = torch.split(xbc, [d_inner, GN, GN], dim=-1)

    dt = F.softplus(dt.float() + params["dt_bias"])        # (B,H)
    A = -torch.exp(params["A_log"])
    xr = xin.reshape(Bsz, H, head_dim)
    xh = (xr * dt[..., None]).float()
    rep = H // n_groups
    Bh = Bmat.reshape(Bsz, n_groups, d_state).repeat_interleave(rep, 1)
    Ch = Cmat.reshape(Bsz, n_groups, d_state).repeat_interleave(rep, 1)

    decay = torch.exp(A[None, :] * dt)                     # (B,H)
    h = state["ssd"] * decay[..., None, None] + \
        xh[..., :, None] * Bh.float()[:, :, None, :]       # (B,H,P,N)
    y = torch.einsum("bhpn,bhn->bhp", h, Ch.float())
    y = y + params["D"][None, :, None] * xr.float()
    y = y.reshape(Bsz, d_inner).to(x_t.dtype)
    y = L.rmsnorm(params["norm"],
                  (y * F.silu(z.float()).to(x_t.dtype))[:, None, :])[:, 0]
    return y @ params["out_proj"], {"ssd": h, "conv": conv_buf}


# ---------------------------------------------------------------------------
# RG-LRU (the RecurrentGemma recurrent block)
# ---------------------------------------------------------------------------


def rglru_block_init(gen, d_model: int, d_rnn: int, *, d_conv: int = 4,
                     dtype=torch.bfloat16, device="cpu") -> Params:
    """The Λ init puts a = exp(-c softplus(Λ)) in (0.9, 0.999) at r = 1:
    Λ = softplus^-1(-log u / c), u uniform there (Griffin's appendix)."""
    u = 0.9 + 0.099 * torch.rand((d_rnn,), generator=gen,
                                 dtype=torch.float32, device=device)
    lam = torch.log(torch.expm1(-torch.log(u) / RGLRU_C))
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "w_gate_branch": L.dense_init(gen, (d_model, d_rnn), 0, dtype, device),
        "w_rnn_branch": L.dense_init(gen, (d_model, d_rnn), 0, dtype, device),
        "conv": conv1d_init(gen, d_rnn, d_conv, dtype, device),
        "w_a": L.dense_init(gen, (d_rnn, d_rnn), 0, dtype, device),
        "w_i": L.dense_init(gen, (d_rnn, d_rnn), 0, dtype, device),
        "b_a": torch.zeros((d_rnn,), **f32),
        "b_i": torch.zeros((d_rnn,), **f32),
        "lambda": lam,
        "out_proj": L.dense_init(gen, (d_rnn, d_model), 0, dtype, device),
    }


def _rglru_gates(params: Params, x: torch.Tensor):
    """(a, b) of h_t = a_t h_{t-1} + b_t, in f32."""
    r = torch.sigmoid(L.matmul_f32(x, params["w_a"]) + params["b_a"])
    i = torch.sigmoid(L.matmul_f32(x, params["w_i"]) + params["b_i"])
    log_a = -RGLRU_C * F.softplus(params["lambda"]) * r          # <= 0
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-9)) * \
        (i * x.float())
    return a, b


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t over axis 1 from h_{-1} = 0, as a doubling
    (Hillis-Steele) scan of the pairs (a, b) under (a1, b1) . (a2, b2) =
    (a1 a2, a2 b1 + b2): log2(S) steps of whole-tensor products, no
    division by the (vanishing) running decay products."""
    S = a.shape[1]
    d = 1
    while d < S:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


def rglru_seq(params: Params, x: torch.Tensor, state: Params | None = None):
    """Recurrent block, sequence mode. x (B, S, D) -> ((B, S, D), cache
    {"h": (B, C) f32, "conv": (B, k-1, C)}). ``state`` continues a
    sequence: its conv buffer precedes x and its h enters the scan as a
    prepended pair (a = 0, b = h)."""
    gate = F.gelu(L.matmul_f32(x, params["w_gate_branch"]),
                  approximate="tanh").to(x.dtype)
    u = x @ params["w_rnn_branch"]
    k = params["conv"]["w"].shape[0]
    if state is not None:
        u_ext = torch.cat([state["conv"], u], dim=1)
        uc = causal_conv1d(params["conv"], u_ext)[:, k - 1:, :]
    else:
        uc = causal_conv1d(params["conv"], u)
    a, b = _rglru_gates(params, uc)                        # (B, S, C) each
    if state is not None:
        a = torch.cat([torch.zeros_like(a[:, :1]), a], dim=1)
        b = torch.cat([state["h"][:, None, :].float(), b], dim=1)
        h = linear_scan(a, b)[:, 1:]
    else:
        h = linear_scan(a, b)
    out = (h.to(x.dtype) * gate) @ params["out_proj"]
    conv_buf = u[:, -(k - 1):, :] if u.shape[1] >= k - 1 else F.pad(
        u, (0, 0, k - 1 - u.shape[1], 0))
    return out, {"h": h[:, -1, :].float(), "conv": conv_buf}


def rglru_step(params: Params, x_t: torch.Tensor, state: Params):
    """Decode step. x_t (B, D); state {"h": (B, C) f32, "conv": (B, k-1,
    C)}."""
    gate = F.gelu(L.matmul_f32(x_t, params["w_gate_branch"]),
                  approximate="tanh").to(x_t.dtype)
    u = x_t @ params["w_rnn_branch"]
    uc, conv_buf = causal_conv1d_step(params["conv"], u, state["conv"])
    a, b = _rglru_gates(params, uc)
    h = a * state["h"] + b
    out = (h.to(x_t.dtype) * gate) @ params["out_proj"]
    return out, {"h": h, "conv": conv_buf}
