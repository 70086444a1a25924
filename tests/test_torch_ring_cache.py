"""The ring KV cache of the port, the twin of ``tests/test_ring_cache.py``.

A ring of ``decode_window`` slots (``ring_cache=True``) decoding from
position 0 must give the logits of the full-length cache with the same
window, before and after the wrap, at rtol = atol = 2e-4 (f32: the two
caches attend over the same keys in another slot order); and the port's
ring must give the JAX ring's logits on the same (bridged) weights at
every step, within 1e-4 (f32 smoke configs; the two frameworks sum their
products in other orders, ~1e-5 on logits of magnitude ~5). The plain
decode attention in ring mode is held to JAX's ``layers.attention`` with
the JAX model's ring ``kpos``, for windows of 0, under and over the ring's
size, at 1e-5 (f32).
"""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import decode_step as jdecode
from repro.models import init_cache as jinit_cache
from repro.models import init_params as jinit
from repro.models import layers as jlayers
from repro_torch import bridge
from repro_torch import configs
from repro_torch.kernels import decode_attention as da
from repro_torch.models import decode_step, init_cache

WINDOW = 8
STEPS = 24
B = 2
ARCHS = ["llama3-8b", "olmoe-1b-7b"]


def _cfgs(cfgs_mod, arch):
    base = cfgs_mod.get_smoke(arch)
    full = dataclasses.replace(base, decode_window=WINDOW,
                               param_dtype="float32")
    return full, dataclasses.replace(full, ring_cache=True)


@partial(jax.jit, static_argnums=(0,))
def _jax_step(cfg, params, tok, cache, pos):
    return jdecode(cfg, params, tok, cache, pos)


def _torch_decode(cfg, params, toks):
    cache = init_cache(cfg, B, STEPS, torch.float32, device="cpu")
    out = []
    for pos in range(STEPS):
        logits, cache = decode_step(cfg, params, torch.from_numpy(toks[pos]),
                                    cache, pos)
        out.append(logits.numpy())
    return np.stack(out), cache


@pytest.fixture(scope="module", params=ARCHS)
def runs(request):
    """Per arch: the JAX ring's logits, and the port's ring and full-cache
    logits on the bridged weights, over STEPS seeded tokens."""
    arch = request.param
    jfull, jring = _cfgs(jconfigs, arch)
    tfull, tring = _cfgs(configs, arch)
    jp = jinit(jfull, jax.random.PRNGKey(0))
    tp = bridge.lm_params(tfull, jax.tree.map(np.asarray, jp), device="cpu")
    toks = np.random.default_rng(7).integers(
        1, jfull.vocab_size, (STEPS, B)).astype(np.int32)
    cache = jinit_cache(jring, B, STEPS, jnp.float32)
    want = []
    for pos in range(STEPS):
        logits, cache = _jax_step(jring, jp, jnp.asarray(toks[pos]), cache,
                                  jnp.asarray(pos, jnp.int32))
        want.append(np.asarray(logits, np.float32))
    ring, ring_cache = _torch_decode(tring, tp, toks)
    full, full_cache = _torch_decode(tfull, tp, toks)
    return dict(jax_ring=np.stack(want), ring=ring, full=full,
                ring_cache=ring_cache, full_cache=full_cache)


def test_ring_cache_matches_full_cache(runs):
    assert runs["ring_cache"]["k"].shape[2] == WINDOW
    assert runs["full_cache"]["k"].shape[2] == STEPS
    for pos in range(STEPS):
        np.testing.assert_allclose(
            runs["ring"][pos], runs["full"][pos], rtol=2e-4, atol=2e-4,
            err_msg=f"pos {pos} ({'pre' if pos < WINDOW else 'post'}-wrap)")


def test_ring_cache_matches_jax_ring(runs):
    for pos in range(STEPS):
        np.testing.assert_allclose(
            runs["ring"][pos], runs["jax_ring"][pos], rtol=0, atol=1e-4,
            err_msg=f"pos {pos}")
    np.testing.assert_array_equal(runs["ring"].argmax(-1),
                                  runs["jax_ring"].argmax(-1))


def test_ring_holds_the_last_window_positions(runs):
    """After STEPS steps slot i holds the key and value of position
    STEPS - 1 - ((STEPS - 1 - i) mod WINDOW): the full cache's row there,
    bit for bit in the first layer (its input is the embedding alone) and
    within the logits' tolerance after it."""
    pos = STEPS - 1
    for i in range(WINDOW):
        p = pos - (pos - i) % WINDOW
        for kv in ("k", "v"):
            ring = runs["ring_cache"][kv][:, :, i].numpy()
            full = runs["full_cache"][kv][:, :, p].numpy()
            np.testing.assert_array_equal(ring[0], full[0])
            np.testing.assert_allclose(ring, full, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("window", [0, 5, 8, 13])
@pytest.mark.parametrize("cache_len", [1, 5, 8, 9, 20, 37])
def test_plain_ring_decode_matches_jax_attention(window, cache_len):
    """decode_attention_plain(ring=True) against JAX's layers.attention
    over the ring with kpos = pos - ((pos - slot) mod M), causal, JAX's
    window (0, under, at and over M = 8)."""
    M, H, KV, hd = WINDOW, 6, 2, 32
    rng = np.random.default_rng(cache_len * 31 + window)
    q = rng.normal(size=(B, H, hd)).astype(np.float32)
    k = rng.normal(size=(B, M, KV, hd)).astype(np.float32)
    v = rng.normal(size=(B, M, KV, hd)).astype(np.float32)
    pos = cache_len - 1
    slots = np.arange(M, dtype=np.int32)[None]
    kpos = np.broadcast_to(pos - np.mod(pos - slots, M), (B, M))
    want = jlayers.attention(
        jnp.asarray(q[:, None]), jnp.asarray(k), jnp.asarray(v),
        q_positions=jnp.full((B, 1), pos, jnp.int32),
        k_positions=jnp.asarray(kpos, jnp.int32), causal=True,
        window=window)[:, 0]
    got = da.decode_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), cache_len,
                                    window=window, ring=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
