"""The model zoo's six families, the counterpart of
``src/repro/models/model.py``: ``init_params``, ``embed_tokens``,
``output_logits``, ``forward``, ``loss_fn``, ``init_cache``, ``prefill``,
``_pad_kv`` and ``decode_step`` for the dense, moe, ssm, hybrid, vlm and
audio families.

* dense / moe: a stack of attention layers; the moe family swaps each
  layer's MLP for :func:`repro_torch.models.layers.moe` and sums its aux
  loss over the layers.
* vlm: the dense stack over the patch embeddings (``batch["patch_embeds"]``
  (B, P, D), cast to the parameter dtype) prepended to the text; positions
  run over the whole sequence, :func:`forward` returns the text positions'
  logits and :func:`prefill` the next position after patches and text.
* ssm: Mamba-2 layers (:mod:`repro_torch.models.ssm`); the cache is the
  SSD state (L, B, H, P, N) f32 and the conv buffer (L, B, k-1, C).
* hybrid: RG-LRU and attention layers in the config's block pattern, kept
  as two stacks (``rglru_layers``, ``attn_layers``); a layer's window is
  that of its overall index. The cache holds k/v of the attention layers
  and h (f32) and the conv buffer of the recurrent ones.
* audio: an encoder of non-causal attention layers over
  ``batch["frames"]`` (B, F, D), then ``enc_norm``; each decoder layer
  adds cross-attention (no RoPE, no mask) over its own K/V of the encoder
  output, which the cache keeps as ``cross_k``/``cross_v``.

Public layouts are the JAX package's: parameters stacked on a leading
layer axis, the KV cache (L, B, M, KV, hd), queries (B, S, H, hd). The
layer scan is a Python loop. Serving sends sequence attention to
``ops.flash_attention`` (causal with the layer's window; the encoder and
cross-attention non-causal) and step attention to
``ops.decode_attention`` with ``cache_len = pos + 1``: one shared position
for the whole batch, so the causal mask over cache slots is exactly a
valid-length mask; a decode step's cross-attention reads the encoder's
F keys with ``cache_len = F``. Unlike the functional JAX version,
:func:`decode_step` updates the cache in place.

The ring KV cache (``ring_cache`` with ``decode_window`` > 0): the cache
holds ``min(max_len, decode_window)`` slots and a decode step writes slot
``pos % M``, so slot i holds position ``pos - ((pos - i) mod M)`` (not yet
written when negative); the decode kernel reads it in ring mode. As in
JAX, a ring is what :func:`init_cache` and :func:`decode_step` from
position 0 build; :func:`prefill` pads its cache to ``max_len``.

The training forward (:func:`forward`, :func:`loss_fn`) runs the same
blocks with the model-level :func:`repro_torch.models.layers.attention`,
which autograd differentiates; the kernels are forward-only and refuse a
tensor that requires grad.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch import tracing
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.config import ModelConfig, assert_valid

Params = dict[str, Any]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

AUX_LOSS_WEIGHT = 0.01

FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")


def param_dtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.param_dtype]


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(cfg.family)


def _ring(cfg: ModelConfig) -> bool:
    return cfg.ring_cache and cfg.decode_window > 0


def layer_params(params: Params, i: int) -> Params:
    """Layer ``i`` of a stack of parameters (leading layer axis)."""
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i]
            for k, v in params.items()}


# ===========================================================================
# Parameter initialization
# ===========================================================================


def _stack_layers(n: int, one) -> Params:
    """n calls of ``one()`` (a tree of one layer's tensors), stacked on a
    leading axis as they are drawn."""
    out: Params = {}

    def fill(dst, src, i):
        for k, v in src.items():
            if isinstance(v, dict):
                fill(dst.setdefault(k, {}), v, i)
            else:
                if k not in dst:
                    dst[k] = torch.empty((n,) + v.shape, dtype=v.dtype,
                                         device=v.device)
                dst[k][i] = v
    for i in range(n):
        fill(out, one(), i)
    return out


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> Params:
    """Random weights from ``torch.Generator(seed)``, with the JAX
    package's distributions: fan-in normal projections, unit-normal
    embedding, zero norm scales; the moe family's layers hold ``moe``
    (:func:`layers.moe_init`) in place of ``mlp``, the ssm family's a
    Mamba-2 ``mixer``, the hybrid's recurrent layers an ``rglru`` block.
    Layers are filled one at a time, so the f32 scratch stays one layer's
    size."""
    assert_valid(cfg)
    _check_family(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dt = param_dtype(cfg)
    D, H, KV, hd, Fd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                        cfg.head_dim, cfg.d_ff)
    nonparam = cfg.norm_type == "nonparametric_ln"

    def stack(n, shape, in_axis=0):
        out = torch.empty((n,) + shape, dtype=dt, device=dev)
        for i in range(n):
            out[i] = L.dense_init(gen, shape, in_axis, dt, dev)
        return out

    def norm(*lead):
        return ({} if nonparam else
                {"scale": torch.zeros(lead + (D,), dtype=torch.float32,
                                      device=dev)})

    def attn(n):
        return {"wq": stack(n, (D, H, hd)), "wk": stack(n, (D, KV, hd)),
                "wv": stack(n, (D, KV, hd)),
                "wo": stack(n, (H, hd, D), in_axis=1)}

    def ffn(n, moe: bool):
        if moe:
            return {"moe": _stack_layers(n, lambda: L.moe_init(
                gen, D, Fd, cfg.num_experts, dt, dev))}
        f = {"w_up": stack(n, (D, Fd)), "w_down": stack(n, (Fd, D))}
        if cfg.gated_mlp:
            f["w_gate"] = stack(n, (D, Fd))
        return {"mlp": f}

    def attn_layers(n, f):
        return {"ln1": norm(n), "attn": attn(n), "ln2": norm(n), **f}

    params: Params = {}

    def head():
        params["embed"] = L.normal(gen, (cfg.vocab_size, D), 1.0, dt, dev)
        params["final_norm"] = norm()

    n = cfg.num_layers
    if cfg.family in ("dense", "moe", "vlm", "audio"):
        f = ffn(n, cfg.family == "moe")   # before the embedding: the order
        head()                            # the dense weights were drawn in
        params["layers"] = attn_layers(n, f)
        if cfg.family == "audio":
            params["layers"]["ln_cross"] = norm(n)
            params["layers"]["cross_attn"] = attn(n)
            params["enc_layers"] = attn_layers(cfg.encoder_layers,
                                               ffn(cfg.encoder_layers, False))
            params["enc_norm"] = norm()
    elif cfg.family == "ssm":
        head()
        params["layers"] = {"ln1": norm(n), "mixer": _stack_layers(
            n, lambda: S.mamba2_init(
                gen, D, d_state=cfg.ssm_state, head_dim=cfg.ssm_head_dim,
                expand=cfg.ssm_expand, n_groups=cfg.ssm_groups,
                d_conv=cfg.d_conv, dtype=dt, device=dev))}
    else:                                   # hybrid
        head()
        blocks = cfg.layer_blocks()
        n_attn, n_rec = blocks.count("a"), blocks.count("r")
        params["attn_layers"] = attn_layers(n_attn, ffn(n_attn, False))
        params["rglru_layers"] = {
            "ln1": norm(n_rec),
            "rglru": _stack_layers(n_rec, lambda: S.rglru_block_init(
                gen, D, cfg.d_rnn, d_conv=cfg.d_conv, dtype=dt, device=dev)),
            "ln2": norm(n_rec), **ffn(n_rec, False)}
    if not cfg.tie_embeddings:
        params["unembed"] = L.dense_init(gen, (cfg.vocab_size, D), 1, dt,
                                         dev)
    return params


def param_shapes(cfg: ModelConfig) -> Params:
    """The parameter tree of ``cfg`` with no storage: :func:`init_params`
    run under a ``FakeTensorMode``, each leaf given back as a meta tensor
    of its shape and dtype (the counterpart of JAX's abstract init)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.tree import tree_map
    with FakeTensorMode():
        fake = init_params(cfg, 0, device="cpu")
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device="meta"), fake)


# ===========================================================================
# Embedding & head
# ===========================================================================


def embed_tokens(cfg: ModelConfig, params: Params, tokens: torch.Tensor):
    dt = param_dtype(cfg)
    x = params["embed"][tokens].to(dt)
    tracing.count("host_sync.model")            # the scale's upload
    return x * torch.tensor(cfg.d_model ** 0.5, dtype=dt, device=x.device)


def output_logits(cfg: ModelConfig, params: Params, x: torch.Tensor):
    x = L.apply_norm(cfg.norm_type, params.get("final_norm"), x)
    w = params["embed"] if cfg.tie_embeddings else params["unembed"]
    return L.unembed(w, x)


# ===========================================================================
# Blocks
# ===========================================================================


def kernel_attention(q, k, v, positions, window: int, causal: bool):
    """Sequence attention for serving: the flash kernel (positions are the
    sequence's own, aligned to its end)."""
    return ops.flash_attention(q, k, v, causal=causal, window=window)


def model_attention(q, k, v, positions, window: int, causal: bool):
    """Sequence attention for training: differentiable
    :func:`layers.attention`."""
    return L.attention(q, k, v, q_positions=positions, k_positions=positions,
                       causal=causal, window=window)


def kernel_cross_attention(q, k, v):
    """Cross-attention for serving: every query reads every encoder key,
    through the flash kernel (non-causal, no window)."""
    return ops.flash_attention(q, k, v, causal=False, window=0)


def model_cross_attention(q, k, v):
    """Cross-attention for training: :func:`layers.attention` at position
    0 for queries and keys, non-causal, as JAX's ``_cross_block``."""
    B = q.shape[0]
    qpos = torch.zeros((B, q.shape[1]), dtype=torch.int32, device=q.device)
    kpos = torch.zeros((B, k.shape[1]), dtype=torch.int32, device=q.device)
    return L.attention(q, k, v, q_positions=qpos, k_positions=kpos,
                       causal=False, window=0)


def _ffn(cfg: ModelConfig, lp: Params, h):
    """The layer's MLP, or its MoE: (output, aux loss or None)."""
    if "moe" in lp:
        return L.moe(lp["moe"], h, experts_per_token=cfg.experts_per_token,
                     capacity_factor=cfg.moe_capacity_factor,
                     dispatch=cfg.moe_dispatch)
    return L.mlp(lp["mlp"], h), None


def _attn_block_seq(cfg: ModelConfig, lp: Params, x, positions,
                    window: int, *, causal: bool, attend=kernel_attention):
    """Attention + FFN residual block over a whole sequence; returns the
    new hidden state, this layer's (k, v) and its aux loss (None without
    a MoE)."""
    h = L.apply_norm(cfg.norm_type, lp.get("ln1"), x)
    q, k, v = L.attention_qkv(lp["attn"], h, positions, cfg.rope_theta)
    attn = attend(q, k, v, positions, window, causal)
    x = x + L.attention_out(lp["attn"], attn)
    h = L.apply_norm(cfg.norm_type, lp.get("ln2"), x)
    f, aux = _ffn(cfg, lp, h)
    return x + f, k, v, aux


def _ffn_step(cfg: ModelConfig, lp: Params, x_t):
    """The FFN residual of a one-token decode."""
    h = L.apply_norm(cfg.norm_type, lp.get("ln2"), x_t[:, None, :])
    return x_t + _ffn(cfg, lp, h)[0][:, 0]


def _attn_block_step(cfg: ModelConfig, lp: Params, x_t, pos: int,
                     cache_len: torch.Tensor, window: int, ck, cv):
    """One-token decode: write k/v at ``pos`` of this layer's cache (slot
    ``pos % M`` of a ring; in place), attend over the cache, then the
    FFN."""
    B = x_t.shape[0]
    ring = _ring(cfg)
    h = L.apply_norm(cfg.norm_type, lp.get("ln1"), x_t[:, None, :])
    qpos = torch.full((B, 1), pos, dtype=torch.int32, device=x_t.device)
    q, k, v = L.attention_qkv(lp["attn"], h, qpos, cfg.rope_theta)
    slot = pos % ck.shape[1] if ring else pos
    ck[:, slot] = k[:, 0]
    cv[:, slot] = v[:, 0]
    w = window
    if cfg.decode_window > 0 and window <= 0:
        w = cfg.decode_window
    attn = ops.decode_attention(q[:, 0], ck, cv, cache_len, window=w,
                                ring=ring)
    x_t = x_t + L.attention_out(lp["attn"], attn[:, None])[:, 0]
    return _ffn_step(cfg, lp, x_t)


def _cross_block(cfg: ModelConfig, lp: Params, x, enc_k, enc_v,
                 attend=kernel_cross_attention):
    """Cross-attention sub-block (audio decoder) over the encoder's
    precomputed K/V: q without RoPE."""
    h = L.apply_norm(cfg.norm_type, lp.get("ln_cross"), x)
    q = L.proj(h, lp["cross_attn"]["wq"])
    return x + L.attention_out(lp["cross_attn"], attend(q, enc_k, enc_v))


def _ssm_block_seq(cfg: ModelConfig, lp: Params, x, state):
    h = L.apply_norm(cfg.norm_type, lp.get("ln1"), x)
    y, new_state = S.mamba2_seq(lp["mixer"], h, d_state=cfg.ssm_state,
                                head_dim=cfg.ssm_head_dim,
                                n_groups=cfg.ssm_groups, chunk=cfg.ssm_chunk,
                                state=state)
    return x + y, new_state


def _ssm_block_step(cfg: ModelConfig, lp: Params, x_t, state):
    h = L.apply_norm(cfg.norm_type, lp.get("ln1"), x_t[:, None, :])[:, 0]
    y, new_state = S.mamba2_step(lp["mixer"], h, state, d_state=cfg.ssm_state,
                                 head_dim=cfg.ssm_head_dim,
                                 n_groups=cfg.ssm_groups)
    return x_t + y, new_state


def _rglru_block_seq(cfg: ModelConfig, lp: Params, x, state):
    h = L.apply_norm(cfg.norm_type, lp.get("ln1"), x)
    y, new_state = S.rglru_seq(lp["rglru"], h, state)
    x = x + y
    h = L.apply_norm(cfg.norm_type, lp.get("ln2"), x)
    return x + L.mlp(lp["mlp"], h), new_state


def _rglru_block_step(cfg: ModelConfig, lp: Params, x_t, state):
    h = L.apply_norm(cfg.norm_type, lp.get("ln1"), x_t[:, None, :])[:, 0]
    y, new_state = S.rglru_step(lp["rglru"], h, state)
    return _ffn_step(cfg, lp, x_t + y), new_state


def _hybrid_layers(cfg: ModelConfig):
    """(kind, index in its stack, overall index) of each hybrid layer."""
    ia = ir = 0
    for i, b in enumerate(cfg.layer_blocks()):
        if b == "a":
            yield "a", ia, i
            ia += 1
        else:
            yield "r", ir, i
            ir += 1


# ===========================================================================
# Inputs and the audio encoder
# ===========================================================================


def _positions(B: int, S_: int, device) -> torch.Tensor:
    return torch.arange(S_, dtype=torch.int32, device=device)[None].expand(
        B, S_)


def _build_inputs(cfg: ModelConfig, params: Params, batch: dict):
    """Token embedding, after the vlm family's patch embeddings: (x,
    positions over the whole sequence, index of the first text
    position)."""
    tokens = batch["tokens"]
    x = embed_tokens(cfg, params, tokens)
    if cfg.family == "vlm":
        x = torch.cat([batch["patch_embeds"].to(x.dtype), x], dim=1)
    B, Stot = x.shape[0], x.shape[1]
    return x, _positions(B, Stot, x.device), Stot - tokens.shape[1]


def _run_encoder(cfg: ModelConfig, params: Params, frames, attend):
    """The audio encoder over the (stub frontend's) frame embeddings:
    non-causal attention layers, then ``enc_norm``."""
    x = frames.to(param_dtype(cfg))
    positions = _positions(x.shape[0], x.shape[1], x.device)
    for i in range(cfg.encoder_layers):
        x = _attn_block_seq(cfg, layer_params(params["enc_layers"], i), x,
                            positions, 0, causal=False, attend=attend)[0]
    return L.apply_norm(cfg.norm_type, params.get("enc_norm"), x)


def _encoder_cross_kv(cfg: ModelConfig, params: Params, enc_out):
    """Each decoder layer's cross K/V of the encoder output (no RoPE):
    (L, B, F, KV, hd) each."""
    ca = params["layers"]["cross_attn"]
    ks = [L.proj(enc_out, ca["wk"][i]) for i in range(cfg.num_layers)]
    vs = [L.proj(enc_out, ca["wv"][i]) for i in range(cfg.num_layers)]
    return torch.stack(ks), torch.stack(vs)


# ===========================================================================
# Full-sequence forward (training)
# ===========================================================================


def forward(cfg: ModelConfig, params: Params, batch: dict):
    """Teacher-forcing forward of ``batch["tokens"]`` (B, S) (and the
    family's frontend input): (logits over the text positions (B, S, V)
    f32, the aux loss summed over the layers: 0 outside the moe
    family)."""
    _check_family(cfg)
    total = torch.zeros((), dtype=torch.float32,
                        device=params["embed"].device)
    if cfg.family == "audio":
        enc = _run_encoder(cfg, params, batch["frames"], model_attention)
        cross_k, cross_v = _encoder_cross_kv(cfg, params, enc)
    x, positions, text_start = _build_inputs(cfg, params, batch)

    if cfg.family in ("dense", "moe", "vlm", "audio"):
        windows = (cfg.layer_windows() if cfg.family != "audio" else
                   (0,) * cfg.num_layers)
        for i, window in enumerate(windows):
            lp = layer_params(params["layers"], i)
            x, _, _, aux = _attn_block_seq(cfg, lp, x, positions, window,
                                           causal=True,
                                           attend=model_attention)
            if cfg.family == "audio":
                x = _cross_block(cfg, lp, x, cross_k[i], cross_v[i],
                                 model_cross_attention)
            if aux is not None:
                total = total + aux
        logits = output_logits(cfg, params, x)
        return logits[:, text_start:], total

    if cfg.family == "ssm":
        for i in range(cfg.num_layers):
            x, _ = _ssm_block_seq(cfg, layer_params(params["layers"], i), x,
                                  None)
        return output_logits(cfg, params, x), total

    windows = cfg.layer_windows()                           # hybrid
    for kind, j, i in _hybrid_layers(cfg):
        if kind == "a":
            x = _attn_block_seq(cfg, layer_params(params["attn_layers"], j),
                                x, positions, windows[i], causal=True,
                                attend=model_attention)[0]
        else:
            x, _ = _rglru_block_seq(
                cfg, layer_params(params["rglru_layers"], j), x, None)
    return output_logits(cfg, params, x), total


def loss_fn(cfg: ModelConfig, params: Params, batch: dict):
    """Masked next-token cross-entropy (labels < 0 are ignored) plus the
    weighted aux loss; metrics ``ce``, ``aux`` and ``accuracy``."""
    logits, aux = forward(cfg, params, batch)
    labels = batch["labels"].long()
    mask = (labels >= 0).float()
    safe = labels.clamp(min=0)
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, safe[..., None])[..., 0]
    denom = torch.clamp(mask.sum(), min=1.0)
    ce = (nll * mask).sum() / denom
    hits = (torch.argmax(logits, dim=-1) == labels).float()
    return ce + AUX_LOSS_WEIGHT * aux, {
        "ce": ce, "aux": aux, "accuracy": (hits * mask).sum() / denom}


# ===========================================================================
# Caches, prefill, decode
# ===========================================================================


def init_cache(cfg: ModelConfig, batch_size: int, max_len: int,
               dtype=None, device="cuda") -> Params:
    """Zero cache. Attention layers: {"k", "v"} (L, B, M, KV, hd) each, M =
    max_len, or ``min(max_len, decode_window)`` slots for a ring. ssm:
    {"ssd": (L, B, H, P, N) f32, "conv": (L, B, k-1, C)}. hybrid: k/v over
    its attention layers, "h" (f32) and "conv" over its recurrent ones.
    audio: k/v plus the encoder's "cross_k"/"cross_v" (L, B, F, KV, hd)."""
    _check_family(cfg)
    dev = resolve_device(device)
    dt = dtype or param_dtype(cfg)
    B = batch_size
    M = min(max_len, cfg.decode_window) if _ring(cfg) else max_len
    KV, hd = cfg.num_kv_heads, cfg.head_dim

    def zeros(*shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def kv(n):
        return {"k": zeros(n, B, M, KV, hd), "v": zeros(n, B, M, KV, hd)}

    if cfg.family in ("dense", "moe", "vlm"):
        return kv(cfg.num_layers)
    if cfg.family == "ssm":
        C = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
        return {"ssd": zeros(cfg.num_layers, B, cfg.ssm_heads,
                             cfg.ssm_head_dim, cfg.ssm_state,
                             dtype=torch.float32),
                "conv": zeros(cfg.num_layers, B, cfg.d_conv - 1, C)}
    if cfg.family == "hybrid":
        blocks = cfg.layer_blocks()
        n_rec = blocks.count("r")
        c = kv(blocks.count("a"))
        c["h"] = zeros(n_rec, B, cfg.d_rnn, dtype=torch.float32)
        c["conv"] = zeros(n_rec, B, cfg.d_conv - 1, cfg.d_rnn)
        return c
    c = kv(cfg.num_layers)                                  # audio
    c["cross_k"] = zeros(cfg.num_layers, B, cfg.encoder_frames, KV, hd)
    c["cross_v"] = torch.zeros_like(c["cross_k"])
    return c


def _pad_kv(kv: Params, max_len: int) -> Params:
    """(L, B, S, KV, hd) -> (L, B, max_len, KV, hd), zero slots after S."""
    S_ = kv["k"].shape[2]
    if max_len < S_:
        raise ValueError(f"cache of {max_len} slots cannot hold {S_}")
    pad = (0, 0, 0, 0, 0, max_len - S_)
    return {"k": torch.nn.functional.pad(kv["k"], pad),
            "v": torch.nn.functional.pad(kv["v"], pad)}


def prefill(cfg: ModelConfig, params: Params, batch: dict, max_len: int):
    """Run the prompt ``batch["tokens"]`` (B, S) (after the vlm family's
    patches; with the audio family's frames) through the model. Returns
    (last-position logits (B, V) f32, cache, next position: the length of
    the whole prefilled sequence)."""
    _check_family(cfg)
    if cfg.family == "audio":
        enc = _run_encoder(cfg, params, batch["frames"], kernel_attention)
        cross_k, cross_v = _encoder_cross_kv(cfg, params, enc)
    x, positions, _ = _build_inputs(cfg, params, batch)
    Stot = x.shape[1]

    if cfg.family == "ssm":
        states = []
        for i in range(cfg.num_layers):
            x, st = _ssm_block_seq(cfg, layer_params(params["layers"], i), x,
                                   None)
            states.append(st)
        cache = {k: torch.stack([st[k] for st in states])
                 for k in ("ssd", "conv")}
        return output_logits(cfg, params, x[:, -1:, :])[:, 0], cache, Stot

    ks, vs, hs, convs = [], [], [], []
    if cfg.family == "hybrid":
        windows = cfg.layer_windows()
        for kind, j, i in _hybrid_layers(cfg):
            if kind == "a":
                x, k, v, _ = _attn_block_seq(
                    cfg, layer_params(params["attn_layers"], j), x, positions,
                    windows[i], causal=True)
                ks.append(k)
                vs.append(v)
            else:
                x, st = _rglru_block_seq(
                    cfg, layer_params(params["rglru_layers"], j), x, None)
                hs.append(st["h"])
                convs.append(st["conv"])
    else:
        windows = (cfg.layer_windows() if cfg.family != "audio" else
                   (0,) * cfg.num_layers)
        for i, window in enumerate(windows):
            lp = layer_params(params["layers"], i)
            x, k, v, _ = _attn_block_seq(cfg, lp, x, positions, window,
                                         causal=True)
            if cfg.family == "audio":
                x = _cross_block(cfg, lp, x, cross_k[i], cross_v[i])
            ks.append(k)
            vs.append(v)
    cache = _pad_kv({"k": torch.stack(ks), "v": torch.stack(vs)}, max_len)
    if cfg.family == "hybrid":
        cache["h"], cache["conv"] = torch.stack(hs), torch.stack(convs)
    if cfg.family == "audio":
        cache["cross_k"], cache["cross_v"] = cross_k, cross_v
    return output_logits(cfg, params, x[:, -1:, :])[:, 0], cache, Stot


def decode_step(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                cache: Params, pos: int):
    """One decode step: ``tokens`` (B,) sit at position ``pos`` (the cache
    holds positions [0, pos), or a ring their last M; the recurrent
    families' state after them). Returns (logits (B, V), cache), the cache
    updated in place."""
    _check_family(cfg)
    x = embed_tokens(cfg, params, tokens[:, None])[:, 0]
    B = x.shape[0]
    cache_len = torch.full((B,), pos + 1, dtype=torch.int32,
                           device=x.device)

    if cfg.family == "ssm":
        for i in range(cfg.num_layers):
            x, st = _ssm_block_step(
                cfg, layer_params(params["layers"], i), x,
                {"ssd": cache["ssd"][i], "conv": cache["conv"][i]})
            cache["ssd"][i], cache["conv"][i] = st["ssd"], st["conv"]
    elif cfg.family == "hybrid":
        windows = cfg.layer_windows()
        for kind, j, i in _hybrid_layers(cfg):
            if kind == "a":
                x = _attn_block_step(
                    cfg, layer_params(params["attn_layers"], j), x, pos,
                    cache_len, windows[i], cache["k"][j], cache["v"][j])
            else:
                x, st = _rglru_block_step(
                    cfg, layer_params(params["rglru_layers"], j), x,
                    {"h": cache["h"][j], "conv": cache["conv"][j]})
                cache["h"][j], cache["conv"][j] = st["h"], st["conv"]
    elif cfg.family == "audio":
        frames = torch.full((B,), cfg.encoder_frames, dtype=torch.int32,
                            device=x.device)

        def cross(q, k, v):
            return ops.decode_attention(q[:, 0], k, v, frames)[:, None]
        for i in range(cfg.num_layers):
            lp = layer_params(params["layers"], i)
            x = _attn_block_step(cfg, lp, x, pos, cache_len, 0,
                                 cache["k"][i], cache["v"][i])
            x = _cross_block(cfg, lp, x[:, None, :], cache["cross_k"][i],
                             cache["cross_v"][i], cross)[:, 0]
    else:
        for i, window in enumerate(cfg.layer_windows()):
            x = _attn_block_step(cfg, layer_params(params["layers"], i), x,
                                 pos, cache_len, window, cache["k"][i],
                                 cache["v"][i])
    return output_logits(cfg, params, x[:, None, :])[:, 0], cache
