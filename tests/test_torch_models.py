"""The port's dense model and embedder against the JAX package's on the
same (bridged) weights: prefill and decode logits within 1e-4, greedy
tokens identical, embeddings at cosine >= 1 - 1e-6; a bf16 model keeps
the MLP's gate/up products and the logits in f32 where JAX does."""
import _torch_threads  # noqa: F401  (a worker's share of the cores)
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.configs import llama3_8b as jllama
from repro.configs import rar_system as jrar
from repro.core import embedder as jemb
from repro.models import decode_step as jdecode
from repro.models import init_params as jinit
from repro.models import layers as jlayers
from repro.models import param_shapes as jparam_shapes
from repro.models import prefill as jprefill
import repro_torch.configs as tconfigs
from repro_torch import bridge
from repro_torch.configs import llama3_8b as tllama
from repro_torch.configs import rar_system as trar
from repro_torch.core import embedder as temb
from repro_torch.data import tokenizer as tk
from repro_torch.models import decode_step, init_params
from repro_torch.models import param_shapes as tparam_shapes
from repro_torch.models import prefill
from repro_torch.models import layers as tlayers

STEPS = 2
CFGS = {"weak": (jrar.WEAK, trar.WEAK), "strong": (jrar.STRONG, trar.STRONG),
        "llama3-smoke": (jllama.SMOKE, tllama.SMOKE)}


@partial(jax.jit, static_argnums=(0,))
def _jax_run(cfg, params, tokens):
    """Prefill, then STEPS greedy decode steps; logits of each."""
    logits, cache, pos = jprefill(cfg, params, {"tokens": tokens},
                                  tokens.shape[1] + STEPS)
    outs = [logits]
    for s in range(STEPS):
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        logits, cache = jdecode(cfg, params, tok, cache, pos + s)
        outs.append(logits)
    return jnp.stack(outs)


def _torch_run(cfg, params, tokens):
    t = torch.from_numpy(tokens).long()
    logits, cache, pos = prefill(cfg, params, {"tokens": t},
                                 t.shape[1] + STEPS)
    outs = [logits]
    for s in range(STEPS):
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        logits, cache = decode_step(cfg, params, tok, cache, pos + s)
        outs.append(logits)
    return torch.stack(outs).numpy()


@pytest.fixture(scope="module")
def bridged():
    out = {}
    for i, (name, (jc, tc)) in enumerate(CFGS.items()):
        jp = jax.jit(jinit, static_argnums=0)(jc, jax.random.PRNGKey(i))
        out[name] = (jc, jp, tc, bridge.lm_params(
            tc, jax.tree.map(np.asarray, jp), device="cpu"))
    return out


@pytest.mark.parametrize("name", list(CFGS))
@pytest.mark.parametrize("length", [1, 7, 17, 26, 130])
def test_prefill_decode_match_jax(bridged, name, length):
    jc, jp, tc, tp = bridged[name]
    rng = np.random.default_rng(length)
    tokens = rng.integers(1, tc.vocab_size, size=(2, length)).astype(
        np.int32)
    want = np.asarray(_jax_run(jc, jp, jnp.asarray(tokens)))
    got = _torch_run(tc, tp, tokens)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_embedder_matches_jax():
    jp = jax.jit(jemb.init_params, static_argnums=0)(jrar.EMBEDDER,
                                                     jax.random.PRNGKey(2))
    tp = bridge.embedder_params(trar.EMBEDDER, jax.tree.map(np.asarray, jp),
                                device="cpu")
    rng = np.random.default_rng(0)
    tokens = np.zeros((5, 16), np.int32)
    for i, n in enumerate([16, 11, 9, 3, 1]):
        tokens[i, :n] = rng.integers(1, trar.EMBEDDER.vocab_size, n)
    want = np.asarray(jax.jit(jemb.embed, static_argnums=0)(
        jrar.EMBEDDER, jp, jnp.asarray(tokens)))
    got = temb.embed(trar.EMBEDDER, tp, tokens).numpy()
    cos = (got * want).sum(-1) / np.linalg.norm(got, axis=-1) / \
        np.linalg.norm(want, axis=-1)
    assert cos.min() >= 1 - 1e-6


def test_embedder_refuses_inner_pad():
    tp = temb.init_params(trar.EMBEDDER, seed=0, device="cpu")
    tokens = np.asarray([[tk.BOS, tk.PAD, 30]], np.int32)
    with pytest.raises(ValueError):
        temb.embed(trar.EMBEDDER, tp, tokens)


def test_torch_init_matches_distribution():
    """Port-side init draws the JAX distributions (fan-in normal), with the
    JAX tree; the bridge accepts it as a JAX tree."""
    p = init_params(trar.WEAK, seed=0, device="cpu")
    wq = p["layers"]["attn"]["wq"]
    assert wq.shape == (3, 128, 4, 32)
    assert abs(wq.std().item() - 128 ** -0.5) < 0.01
    assert abs(p["embed"].std().item() - 1.0) < 0.05
    tree = jax.tree.map(lambda t: t.numpy(), p)
    bridge.lm_params(trar.WEAK, tree, device="cpu")


# ---------------------------------------------------------------------------
# bf16 cast points
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def bf16_weak():
    """WEAK at 2 layers with bf16 weights, bridged bit for bit."""
    jc = dataclasses.replace(jrar.WEAK, param_dtype="bfloat16", num_layers=2)
    tc = dataclasses.replace(trar.WEAK, param_dtype="bfloat16", num_layers=2)
    jp = jax.jit(jinit, static_argnums=0)(jc, jax.random.PRNGKey(0))
    return jc, jp, tc, bridge.lm_params(tc, jax.tree.map(np.asarray, jp),
                                        device="cpu")


def test_bf16_mlp_and_unembed_keep_f32_products(bf16_weak):
    """JAX keeps the gate/up products and the logits in f32
    (``preferred_element_type``); rounding them to bf16 first puts the MLP
    output ~1e-2 and the logits ~1e-2 off. The products of bf16 values are
    exact in f32, so only the order of the f32 sums differs: 1e-6 on the
    MLP's bf16 output (no rounding flips at these inputs), 1e-5 on logits
    of magnitude ~5."""
    jc, jp, tc, tp = bf16_weak
    x = np.random.default_rng(0).normal(size=(2, 9, 128)).astype(np.float32)
    xj, xt = jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).bfloat16()
    jm = jax.tree.map(lambda a: a[0], jp["layers"]["mlp"])
    tm = {k: v[0] for k, v in tp["layers"]["mlp"].items()}
    want = np.asarray(jlayers.mlp(jm, xj).astype(jnp.float32))
    got = tlayers.mlp(tm, xt).float().numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    want = np.asarray(jlayers.unembed(jp["unembed"], xj))
    got = tlayers.unembed(tp["unembed"], xt)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_bf16_prefill_matches_jax(bf16_weak):
    """One-token prompts make attention exact on both sides (softmax over
    one key), so the whole bf16 model is held at 1e-5 against the JAX
    prefill run op by op (jitted, XLA keeps bf16 intermediates in f32 and
    rounds elsewhere); before the fix the logits were 9e-3 off. Longer
    prompts differ by design in attention (``layers.attention`` rounds its
    probabilities to bf16, the kernels do not): greedy tokens identical."""
    jc, jp, tc, tp = bf16_weak
    rng = np.random.default_rng(1)
    tokens = rng.integers(1, tc.vocab_size, size=(4, 1)).astype(np.int32)
    with jax.disable_jit():
        want = np.asarray(jprefill(jc, jp, {"tokens": jnp.asarray(tokens)},
                                   3)[0])
    got = prefill(tc, tp, {"tokens": torch.from_numpy(tokens).long()}, 3)[0]
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    tokens = rng.integers(1, tc.vocab_size, size=(4, 17)).astype(np.int32)
    want = np.asarray(_jax_run(jc, jp, jnp.asarray(tokens)))
    got = _torch_run(tc, tp, tokens)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


# ---------------------------------------------------------------------------
# param_shapes: the abstract init
# ---------------------------------------------------------------------------


PARAM_SHAPE_CFGS = {
    **{a: (jconfigs.get(a), tconfigs.get(a)) for a in jconfigs.all_archs()},
    "rar-weak": (jrar.WEAK, trar.WEAK), "rar-strong": (jrar.STRONG,
                                                       trar.STRONG),
    "rar-smoke": (jrar.SMOKE, trar.SMOKE)}


@pytest.mark.parametrize("name", list(PARAM_SHAPE_CFGS))
def test_param_shapes_match_jax(name):
    """``param_shapes`` gives JAX's abstract tree leaf for leaf (key path,
    shape, dtype) at every arch's FULL width, as meta tensors: no
    storage."""
    jc, tc = PARAM_SHAPE_CFGS[name]
    want = {jax.tree_util.keystr(p): (tuple(s.shape), str(s.dtype))
            for p, s in jax.tree_util.tree_leaves_with_path(
                jparam_shapes(jc))}
    got = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{path}[{k!r}]")
            return
        assert t.device.type == "meta", path
        got[path] = (tuple(t.shape), str(t.dtype).removeprefix("torch."))

    walk(tparam_shapes(tc), "")
    assert got == want
