"""The serving engine over the zoo's state-carrying and frontend families,
against the JAX package: the twins of ``tests/test_serving.py``'s
``test_ssm_generate_runs`` and ``test_hybrid_generate_runs``, and a vlm
and an audio request served with their frontend input.

Smoke configs at f32 on JAX's weights through the bridge; the port's
greedy tokens must equal JAX's ``greedy_generate`` exactly. The vlm case
fails without the engine passing ``patch_embeds`` on and sizing the cache
for the patch positions (``ServingEngine.generate`` once sent only the
tokens, and ``greedy_generate`` sized the cache by them).
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import init_params as jinit
from repro.serving.engine import greedy_generate as jgreedy
from repro_torch import bridge, configs
from repro_torch.models import forward
from repro_torch.serving.engine import ServingEngine, greedy_generate

MAX_NEW = 4


def _bridged(arch, seed):
    jc, tc = jconfigs.get_smoke(arch), configs.get_smoke(arch)
    jp = jax.jit(jinit, static_argnums=0)(jc, jax.random.PRNGKey(seed))
    return jc, jp, tc, bridge.lm_params(tc, jax.tree.map(np.asarray, jp),
                                        device="cpu")


def _jax_tokens(jc, jp, batch):
    fn = jax.jit(partial(jgreedy, jc, max_new=MAX_NEW))
    return np.asarray(fn(params=jp, batch={k: jnp.asarray(v)
                                           for k, v in batch.items()}))


def _greedy_reference(cfg, params, batch):
    """Greedy tokens by re-running the training forward on the grown
    sequence (no cache), as ``test_serving.greedy_reference``."""
    cur = torch.from_numpy(batch["tokens"]).long()
    front = {k: torch.from_numpy(v) for k, v in batch.items()
             if k != "tokens"}
    out = []
    for _ in range(MAX_NEW):
        logits, _ = forward(cfg, params, {"tokens": cur, **front})
        nxt = logits[:, -1].argmax(-1)
        out.append(nxt)
        cur = torch.cat([cur, nxt[:, None]], 1)
    return torch.stack(out, 1).numpy()


@pytest.mark.parametrize("arch,seed", [("mamba2-2.7b", 2),
                                       ("recurrentgemma-2b", 3)])
def test_state_carrying_generate_matches_jax(rng, arch, seed):
    """ssm and hybrid (``test_ssm_generate_runs``,
    ``test_hybrid_generate_runs``): the SSD / RG-LRU states and the
    hybrid's mixed cache carried across decode steps."""
    jc, jp, tc, tp = _bridged(arch, seed)
    batch = {"tokens": rng.integers(1, tc.vocab_size, (2, 16)).astype(
        np.int32)}
    got = greedy_generate(tc, tp, {"tokens": torch.from_numpy(
        batch["tokens"]).long()}, MAX_NEW).numpy()
    assert got.shape == (2, MAX_NEW)
    np.testing.assert_array_equal(got, _jax_tokens(jc, jp, batch))
    np.testing.assert_array_equal(got, _greedy_reference(tc, tp, batch))


@pytest.mark.parametrize("arch,key", [("phi-3-vision-4.2b", "patch_embeds"),
                                      ("whisper-medium", "frames")])
def test_engine_serves_frontend_input_like_jax(rng, arch, key):
    """A vlm request with its patch embeddings and an audio request with
    its frames through ``ServingEngine.generate``: JAX's greedy tokens;
    the frontend key is part of the variant key, and billing counts the
    text tokens, as the JAX engine's."""
    jc, jp, tc, tp = _bridged(arch, 4)
    n = tc.num_patches if key == "patch_embeds" else tc.encoder_frames
    batch = {"tokens": rng.integers(1, tc.vocab_size, (2, 11)).astype(
        np.int32),
        key: rng.normal(size=(2, n, tc.d_model)).astype(np.float32)}
    engine = ServingEngine(tc, tp)
    got = engine.generate(batch, MAX_NEW).numpy()
    np.testing.assert_array_equal(got, _jax_tokens(jc, jp, batch))
    np.testing.assert_array_equal(got, _greedy_reference(tc, tp, batch))
    engine.generate(batch, MAX_NEW)
    assert engine.stats()["jit_variants"] == 1
    assert engine.stats()["jit_hits"] == 1
    assert engine.stats()["calls"] == 4
    assert engine.stats()["tokens_processed"] == 2 * (22 + 2 * MAX_NEW)
